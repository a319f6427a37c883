#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, and hold each of
its hand-written kernels against its plain PyTorch version.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one line each; any failure exits non-zero, and nothing falls back
to the CPU:

  1. device   — a CUDA card is required; its name and power limit; the
                card's arithmetic held to the reference's (no TF32, bf16
                products summed in f32).
  2. build    — compile the four kernel libraries (GP, flash attention,
                Mamba2 SSD, RWKV6 WKV) from src/repro_torch/kernels/csrc
                into build/repro_torch/, one nvcc each, all started
                together, and load them.
  3. kernels  — each kernel against its plain version at its path's
                shapes, with its device time (torch.profiler; a window the
                profiler returns empty is taken again, and after three
                empty ones the row is timed with CUDA events and named in
                the record's `event_timed`), its time per
                back-to-back call (CUDA events), the plain version's device
                time, the least time the card could take (bound) and, for
                attention, PyTorch's scaled_dot_product_attention on the
                same inputs as a yardstick (timed only; the port never
                calls it).  First the launch floor: the device time of the
                least kernel (zero_() of one element), which the small
                shapes' rows are read against.  The covariance gradient
                (gp_kernel_matrix_grad, two kernels per call, asserted)
                at the fit's n = 256 and at 2,048, against its plain closed
                form.  The WKV also at a strong decay (log w = -1.5,
                where the reference's chunked form overflows), held against
                the sequential recurrence.  An SSD or WKV call is three
                kernels (chunk states, the scan over chunks, the output):
                its row sums their device time, gives each one's
                (`phase_ms`), and states the kernels per call (exactly
                three, asserted) and the scratch bytes.
  4. main     — the paper's loop through the port's entry points: 256 GS2
                solves on the Executor (8 persistent workers, GP runtime
                predictor), one naive fresh-server pass, a GP fit, a
                100,000-task backlog re-costed through PackingPolicy and
                trust-scored through SurrogateOffload, a partitioned engine
                at n=8,192 predicting the same backlog, and QoI quadrature.
                The kernels' launch counters are zeroed just before and
                must all have risen just after.  The card's predictions are
                held against the port on the CPU for the same posterior.
                Then, outside the counted run, one fit step profiled
                (main.gp_fit: kernels, device and host ms per step) and
                K(X, X)'s gradient timed the port's way against the plain
                autograd, alternating.
  5. sim      — the paper's scheduling comparison through the port, on
                main's posterior and backlog: Table III (simulate over the
                four workloads x q in {2, 10} x slurm / hq / umb-slurm at
                seed 7, the gs2 column the port's runtime table solved on
                the card, the paper's bands asserted); simulate_cluster of
                a 2,048-task GS2-shaped trace on 64 hq workers (SJF over
                the GP runtime predictor, the GP surrogate offload on the
                broker, the metrics registry, the invariants), then its
                first 256 tasks on the card (profiled) against the port on
                the CPU; adaptive delegation of 64 requests (GS2 solves on
                8 persistent workers) on the incremental and partitioned
                engines; the quickstart's mix through the LoadBalancer and
                4 MCMC chains of 200 steps on its GP surrogate.  Each
                path's GP launch counters are zeroed just before it and
                read just after.
  6. serve    — LM serving of zamba2-2.7b at its published widths (54
                layers, d_model 2560, bf16, random weights from a seed)
                through the Executor: 8 requests on one persistent server
                (prompts of 64-1023 tokens, 16 new tokens each), then 2 on
                fresh servers.  The attention and SSD launch counters are
                zeroed just before; attention must have launched, and the
                SSD at least once per layer per request.
  7. serve_rwkv — the same mix for rwkv6-3b at its published widths (32
                layers, d_model 2560, vocab 65536, bf16): the WKV launch
                counter is zeroed just before and must read at least one
                launch per layer per request just after.
  8. serve_check — outside the timed windows, in f32 at full width:
                zamba2 2 groups (12 layers) deep and rwkv6 4 layers deep.
                Greedy tokens equal the argmax of repeated full forwards,
                and prefill logits on the card match the port on the CPU
                with the same weights.
  9. where    — outside the counted runs: one GS2 solve alone, and the
                device's busy share (torch.profiler) during a solve, a
                10,000-task re-cost and one zamba2 and one rwkv6 request
                each (a 512-token prefill, then prefill + 16 new tokens),
                with the operators that take the device time in the serve
                windows.

Before the last line it prints one JSON object with every kernel's
numbers; the last line is {"ok": true, "device": {...}}.  The full record
is also written to chiprun_out/chip_smoke.json.
"""
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): HBM rate, f32 FLOP/s
# outside the tensor cores (the GP kernels and the SSD recurrence are f32
# work) and dense bf16 tensor-core FLOP/s (bf16 attention products)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

N_SIMS = 256
N_WORKERS = 8
N_NAIVE = 32
N_BACKLOG = 100_000
N_PARTITIONED = 8_192
FIT_STEPS = 150

SERVE_ARCH = "zamba2-2.7b"
RWKV_ARCH = "rwkv6-3b"
SERVE_REQUESTS = 8
SERVE_FRESH = 2
SERVE_MAX_NEW = 16
SERVE_MAX_LEN = 2048
SERVE_MIN_PROMPT = 64


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def call_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call of `fn` over `iters` back-to-back calls (CUDA
    events): the larger of the device work and the host's enqueue work."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the kernel rows whose device time the profiler did not see, timed with
# CUDA events instead (logged, and kept in chiprun_out/chip_smoke.json)
EVENT_TIMED: list = []


def device_ms(fn, iters: int, warmup: int = 3, label: str = "",
              by_kernel: dict | None = None, expect: int = 0) -> float:
    """Mean device time per call of `fn`: the summed time of every kernel
    it launched (torch.profiler), over `iters` calls.  Back-to-back event
    timing of a tens-of-microseconds kernel measures the wrapper's host
    work instead, so this is the kernel's time.  Each window opens with a
    warm-up step of one untimed call, so that the tracer is running before
    the timed calls start (a window opened cold can miss its first
    kernel).  The profiler now and then still returns a window with no
    device events at all, or, where `expect` says each call launches that
    many kernels, fewer kernel events than `expect * iters`; such a window
    is taken again, and after three of them the calls are timed with CUDA
    events (`call_ms`, an upper bound on the device time) and the row is
    named in EVENT_TIMED.  `by_kernel`, where given, receives each
    kernel's name and its (device ms, launches) per call from the profiler
    window; it stays empty when the calls were event-timed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = _kernel_events(prof)
        busy = sum(e.self_device_time_total for e in events) / 1e3
        seen = sum(e.count for e in events)
        if busy > 0.0 and seen >= expect * iters:
            if by_kernel is not None:
                for e in events:
                    by_kernel[e.key] = (e.self_device_time_total / 1e3
                                        / iters, e.count / iters)
            return busy / iters
        log("timing", label=label, window=attempt,
            note=("the profiler recorded no device time" if busy == 0.0
                  else f"the profiler saw {seen} of the "
                       f"{expect * iters} kernel launches"))
    ms = call_ms(fn, iters, warmup=0)
    EVENT_TIMED.append(dict(label=label, ms=ms))
    log("timing", label=label, timer="cuda events", ms=ms)
    return ms


def _kernel_events(prof):
    """The device-side events (kernels, copies) of a profiler window.  A
    CPU operator's self device time repeats its kernels' time, so a sum
    over every event counts each launched kernel twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _device_busy_ms(prof) -> float:
    """Sum of device time over the kernels a profiler window recorded."""
    return sum(e.self_device_time_total for e in _kernel_events(prof)) / 1e3


def launch_floor_ms() -> float:
    """Device ms of the least kernel the card runs: zero_() of a one-element
    tensor, timed as the kernel rows are (device_ms, 200 calls)."""
    import torch
    t = torch.empty(1, device="cuda")
    return device_ms(t.zero_, 200, label="launch floor")


def host_ms(fn, iters: int) -> float:
    """Host ms per call of `fn` over `iters` calls ending in a synchronize
    (perf_counter, no profiler)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def fit_step_profile(x, y, steps: int = 5, rounds: int = 5) -> dict:
    """One step of the GP fit as `uq.gp._fit` takes it (nlml, then the
    gradient of every log-parameter), at the initial parameters, rbf, on
    the card: the kernels a step launches and their device ms (a profiler
    window of `steps` steps), and its host ms (`host_ms` over `steps`
    steps, outside the profiler).  Then K(X, X) and its gradient in the
    lengthscale and variance alone, the port's way (`gp_kernel_matrix`
    and its backward) and the old way (the plain `ref.gp_kernel_matrix`
    on CUDA tensors under autograd), the two alternating in `rounds`
    rounds so that host noise falls on both: kernels, device ms and host
    ms per call (host ms: the median of the rounds)."""
    import statistics
    import torch
    from repro_torch.kernels import gp_kernel, ref
    from repro_torch.uq import gp as gp_lib
    x = gp_lib.as_f32(x, "cuda")
    y2 = gp_lib.as_f32(y, "cuda")
    mean, std = gp_lib._standardise(y2)
    yn = (y2 - mean) / std
    tree0 = gp_lib.GPParams.init(x.shape[1], x.device).tree()

    def step():
        leaves = {k: a.detach().requires_grad_() for k, a in tree0.items()}
        loss = gp_lib.nlml(leaves, x, yn, "rbf")
        torch.autograd.grad(loss, list(leaves.values()))

    def measure(fn, label):
        # every kernel launches a whole number of times per call, so a
        # fractional count is an event the profiler dropped: such a window
        # is taken again, up to four times, and the fullest one kept
        best = None
        for _ in range(4):
            by_kernel = {}
            dev = device_ms(fn, steps, warmup=2, label=label,
                            by_kernel=by_kernel)
            count = sum(c for _, c in by_kernel.values())
            whole = bool(by_kernel) and all(
                abs(c - round(c)) < 1e-9 for _, c in by_kernel.values())
            if whole or best is None or count > best[0]:
                best = (count, dev, by_kernel, whole)
            if whole:
                break
        count, dev, by_kernel, whole = best
        names = {}
        for k, (_, c) in by_kernel.items():
            names[k[:60]] = names.get(k[:60], 0.0) + c
        return dict(kernels=count if by_kernel else None, device_ms=dev,
                    whole_counts=whole,
                    by_kernel=dict(sorted(names.items(),
                                          key=lambda kv: -kv[1])))

    out = dict(n=x.shape[0], d=x.shape[1], outputs=yn.shape[1],
               step=measure(step, "fit step"))
    out["step"]["host_ms"] = statistics.median(
        host_ms(step, steps) for _ in range(rounds))

    g = torch.Generator(device="cuda").manual_seed(2)
    up = torch.randn(x.shape[0], x.shape[0], generator=g, device="cuda")
    ls = torch.ones(x.shape[1], device="cuda", requires_grad=True)
    var = torch.ones((), device="cuda", requires_grad=True)
    ways = {"port": gp_kernel.gp_kernel_matrix,
            "plain_autograd": ref.gp_kernel_matrix}
    calls = {name: (lambda f=f: torch.autograd.grad(f(x, x, ls, var),
                                                    (ls, var), up))
             for name, f in ways.items()}
    out["k_grad"] = {name: measure(fn, f"K grad {name}")
                     for name, fn in calls.items()}
    hosts = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            hosts[name].append(host_ms(fn, 20))
    for name, ms in hosts.items():
        out["k_grad"][name].update(host_ms=statistics.median(ms),
                                   host_ms_rounds=ms)
    return out


def bound_ms(n_bytes: float, n_ops: float, flop_per_s: float = F32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a - b).abs().max())


# ---------------------------------------------------------------------------
def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is "
                           "available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    from repro_torch import device
    device.strict_numerics()
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction):
        raise RuntimeError("TF32 or reduced-precision bf16 sums are on; "
                           "the reference sums in f32")
    name = torch.cuda.get_device_name(0)
    log("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def phase_build():
    """Build the four libraries at once (one nvcc each, from threads)."""
    from repro_torch.kernels import (flash_attention, gp_kernel, mamba2_ssd,
                                     rwkv6_wkv)
    mods = (gp_kernel, flash_attention, mamba2_ssd, rwkv6_wkv)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        for f in [pool.submit(m.load) for m in mods]:
            f.result()
    seconds = time.perf_counter() - t0
    for m in mods:
        regs = [ln.strip() for ln in str(m.build_info["log"]).splitlines()
                if "registers" in ln or "spill" in ln]
        log("build", library=m.build_info["path"],
            nvcc_s=f"{m.build_info['seconds']:.2f}", ptxas=regs)
    log("build", seconds=f"{seconds:.2f}")
    return seconds


def _linv(k, jitter=1e-2):
    import torch
    n = k.shape[-1]
    eye = torch.eye(n, device=k.device)
    chol = torch.linalg.cholesky(k + jitter * eye)
    return torch.linalg.solve_triangular(
        chol, eye.expand_as(k), upper=False).contiguous()


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from repro_torch.kernels import gp_kernel, ref
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    rows = []
    src = "src/repro_torch/kernels/csrc/gp_kernel.cu"
    d = 7
    floor = launch_floor_ms()
    log("kernel", launch_floor_ms=f"{floor:.6g}")

    # gp_kernel_matrix: K(X, X) of a 2,048-point GS2 training set, both
    # kinds; then the main path's own shapes (rbf, its kind): the GP fit
    # at n = 256 (N_SIMS), the partitioned fit's subsample of 512 and an
    # expert of expert_cap = 128
    var = torch.tensor(1.7, device=dev)
    for n, kind, label in ((2048, "rbf", "rbf"), (2048, "matern52", "matern52"),
                           (256, "rbf", "rbf n=256"), (512, "rbf", "rbf n=512"),
                           (128, "rbf", "rbf n=128")):
        x = randn(n, d)
        ls = torch.exp(0.2 * randn(d))
        got = gp_kernel.gp_kernel_matrix(x, x, ls, var, kind)
        torch.cuda.synchronize()
        want = ref.gp_kernel_matrix(x, x, ls, var, kind)
        err = max_err(got, want)
        if not err <= 2e-5:
            raise AssertionError(f"gp_kernel_matrix {label}: {err} > 2e-5")
        run = (lambda: gp_kernel.gp_kernel_matrix(x, x, ls, var, kind))
        ms = device_ms(run, 200, label=f"gp_kernel_matrix[{label}]", expect=1)
        call = call_ms(run, 200)
        plain = device_ms(lambda: ref.gp_kernel_matrix(x, x, ls, var, kind),
                          200, label=f"plain gp_kernel_matrix[{label}]")
        per_elem = 2 * d + 6 + (8 if kind == "matern52" else 2)
        b, by = bound_ms(4 * (2 * n * d + d + 1) + 4 * n * n,
                         n * n * per_elem + 2 * n * 2 * d)
        rows.append(dict(name=f"gp_kernel_matrix[{label}]", shape=f"{n}x{n}x{d}",
                         max_abs_err=err, tol=2e-5, ms=ms, call_ms=call,
                         plain_ms=plain, bound_ms=b, bound_by=by,
                         launch_floor_ms=floor))

    # gp_kernel_matrix_grad: the gradient of K(X, X) in the lengthscale and
    # variance against an upstream gradient of both signs, at the fit's
    # n = 256 and at 2,048, held to the plain closed form at 1e-5 of each
    # component's sum of absolute terms.  A call is two kernels (the
    # tiles' partial sums, their fixed-order reduction): its row sums
    # their device time, gives each one's, and asserts two per call.
    for n, kind in ((256, "rbf"), (2048, "rbf"), (2048, "matern52")):
        x = randn(n, d)
        ls = torch.exp(0.2 * randn(d) + 0.5)
        up = randn(n, n)
        args = (up, x, x, ls, var, kind)
        got = gp_kernel.gp_kernel_matrix_grad(*args)
        torch.cuda.synchronize()
        want = ref.gp_kernel_matrix_grad(*args)
        scale = ref.gp_kernel_matrix_grad(up.double().abs(), x.double(),
                                          x.double(), ls.double(),
                                          var.double(), kind)
        err = max(max_err(a, b) for a, b in zip(got, want))
        rel = max(float(((a.double() - b.double()).abs() / s).max())
                  for a, b, s in zip(got, want, scale))
        label = f"gp_kernel_matrix_grad[{kind} n={n}]"
        if not rel <= 1e-5:
            raise AssertionError(f"{label}: {rel} of the terms' scale > 1e-5")
        run = (lambda: gp_kernel.gp_kernel_matrix_grad(*args))
        kernels = {}
        ms = device_ms(run, 200, label=label, by_kernel=kernels,
                       expect=len(GP_GRAD_PHASES))
        phase_ms, per_call = _phases(kernels, GP_GRAD_PHASES)
        if per_call is not None and per_call != 2:
            raise AssertionError(f"{label}: {per_call} kernels per call")
        plain = device_ms(lambda: ref.gp_kernel_matrix_grad(*args), 20,
                          label=f"plain {label}")
        # bytes: G, x and ls read once, g_ls and g_var written once;
        # operations per element: the cross term (2d), d2 (3), the
        # correlation and h (rbf 4, matern52 12), g_var's multiply-add (2)
        # and the squared differences' subtract, multiply, multiply-add
        # (3d) and G h (1)
        per_elem = 5 * d + 6 + (12 if kind == "matern52" else 4)
        b, by = bound_ms(4 * (n * n + n * d + d + 1) + 4 * (d + 1),
                         n * n * per_elem + 2 * n * 2 * d)
        rows.append(dict(
            name=label, shape=f"{n}x{n}x{d}", max_abs_err=err,
            rel_to_terms=rel, tol="1e-5 of each component's sum |term|",
            ms=ms, call_ms=call_ms(run, 200), plain_ms=plain, bound_ms=b,
            bound_by=by, launch_floor_ms=floor,
            kernel_launches_per_call=per_call, phase_ms=phase_ms,
            scratch_bytes=4 * math.prod(gp_kernel.grad_scratch(n, n, d)),
            note="ms sums the device time of the call's two kernels (the "
                 "tiles' partial sums, their fixed-order reduction); the "
                 "launches per call and phase_ms are counted in the "
                 "profiler window, null where it was event-timed"))

    # gp_predict: the predictor's 256-point posterior and a 2,048-point
    # one, against the top bucket (1,024 queries), two outputs; then
    # gp_predict_experts: 64 experts of expert_cap=128, 1,024 queries
    # each, one output.  Then the `sim` phase's shapes: one query on the
    # 256-point posterior (the offload's trust check), and the adaptive
    # stream's partitioned engine on main's posterior: 2 or 3 experts
    # stacked at cap 128, every other one zero-padded past its first 100
    # rows, one live query padded to the smallest bucket (64) with zero
    # rows, as `PartitionedEngine.predict_batch` stacks them, two
    # outputs.  A call is three kernels (K0 and the mean's partials, the
    # triangular product, the reduction with the scaling): its row sums
    # their device time, gives each one's (phase_ms), and states the
    # kernels per call (exactly three, asserted) and the scratch bytes.
    for name, e, n, s, m, label in (
            ("gp_predict", 1, 256, 1024, 2, "gp_predict[n=256]"),
            ("gp_predict", 1, 2048, 1024, 2, "gp_predict[n=2048]"),
            ("gp_predict_experts", 64, 128, 1024, 1, "gp_predict_experts"),
            ("gp_predict", 1, 256, 1, 2, "gp_predict[n=256 s=1]"),
            ("gp_predict_experts", 2, 128, 64, 2,
             "gp_predict_experts[e=2 s=1 of 64]"),
            ("gp_predict_experts", 3, 128, 64, 2,
             "gp_predict_experts[e=3 s=1 of 64]")):
        xt, xs = randn(e, n, d), randn(e, s, d)
        ls = 2.0 * torch.exp(0.2 * randn(d))
        var = torch.tensor(1.3, device=dev)
        linv = _linv(ref.gp_kernel_matrix(xt, xt, ls, var))
        alpha = randn(e, n, m)
        if "of 64" in label:
            for t in (xt[1::2, 100:], alpha[1::2, 100:], linv[1::2, 100:],
                      linv[1::2, :, 100:], xs[:, 1:], xs[1:]):
                t.zero_()
        args = (xt, xs, ls, var, alpha, linv)
        if e == 1:
            args = tuple(a[0] if a.dim() == 3 else a for a in args)
        fn = getattr(gp_kernel, name)
        got = fn(*args)
        torch.cuda.synchronize()
        want = getattr(ref, name)(*args)
        err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        if not err <= 1e-4:
            raise AssertionError(f"{label}: {err} > 1e-4")
        run = (lambda: fn(*args))
        kernels = {}
        ms = device_ms(run, 50, label=label, by_kernel=kernels,
                       expect=len(GP_PREDICT_PHASES))
        phase_ms, per_call = _phases(kernels, GP_PREDICT_PHASES)
        plain = device_ms(lambda: getattr(ref, name)(*args), 50,
                          label=f"plain {label}")
        tri = n * (n + 1) // 2
        b, by = bound_ms(4 * e * (n * d + s * d + n * m + tri + s * m + s)
                         + 4 * (d + 1),
                         e * s * (2 * tri + n * (2 * d + 2 * m + 8)))
        rows.append(dict(
            name=label, shape=f"e{e} n{n} s{s} m{m}", max_abs_err=err,
            tol=1e-4, ms=ms, call_ms=call_ms(run, 50), plain_ms=plain,
            bound_ms=b, bound_by=by, kernel_launches_per_call=per_call,
            phase_ms=phase_ms, scratch_bytes=4 * sum(
                math.prod(shape) for shape in
                gp_kernel.predict_scratch(e, n, s, m).values()),
            note="ms sums the device time of the call's three kernels "
                 "(K0, triangular product, reduction); the launches per "
                 "call and phase_ms are counted in the profiler window, "
                 "null where it was event-timed"))
    for r in rows:
        r.update(source=src, library_ms=None)
        log("kernel", **{k: (f"{v:.6g}" if isinstance(v, float) else v)
                         for k, v in r.items()})
    return rows


def _attn_bound(q, k, v):
    """Causal attention.  Bytes: q, k, v read once and the output written
    once.  Operations: 2 (Dh + Dv) per visible (query, key) pair, at the
    bf16 tensor-core peak for bf16 inputs (the products' type) and the f32
    CUDA-core peak for f32 (the port allows no TF32)."""
    import torch
    b, sq, h, dh = q.shape
    skv, dv = k.shape[1], v.shape[3]
    # row r sees keys 0 .. r + skv - sq
    pairs = sum(min(skv, r + skv - sq + 1) for r in range(sq))
    elem = q.element_size()
    n_bytes = elem * (q.numel() + k.numel() + v.numel() + b * sq * h * dv)
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    return bound_ms(n_bytes, b * h * pairs * 2 * (dh + dv), peak)


def _ssd_bound(x, b_in, state):
    """Bytes: x, dt, B, C, A, D and the state read once, y and the final
    state written once.  Operations: the recurrence's 5 f32 operations per
    (t, h, p, n) (decay, input product, add, and the C . state
    multiply-add), the least the function needs, at the f32 CUDA-core
    peak: the state and decays are f32 in the reference."""
    bb, s, h, p = x.shape
    n = b_in.shape[2]
    elem = x.element_size()
    n_bytes = (2 * elem * x.numel() + 4 * bb * s * h + 2 * elem * b_in.numel()
               + 8 * h + 4 * bb * h * p * n * (2 if state is not None else 1))
    return bound_ms(n_bytes, 5 * bb * s * h * p * n)


# the three kernels of one gp_predict / gp_predict_experts, one mamba2_ssd
# and one rwkv6_wkv call, and the two of one gp_kernel_matrix_grad call, in
# launch order (their names as the profiler shows them contain these)
GP_PREDICT_PHASES = ("gp_predict_k0", "gp_predict_tri", "gp_predict_reduce")
GP_GRAD_PHASES = ("gp_kernel_matrix_grad_tiles", "gp_kernel_matrix_grad_reduce")
SSD_PHASES = ("ssd_chunk_state", "ssd_state_scan", "ssd_chunk_output")
WKV_PHASES = ("wkv_chunk_state", "wkv_state_scan", "wkv_chunk_output")


def _phases(by_kernel: dict, names):
    """From one profiler window of calls: each named kernel's device ms
    per call, and the kernels launched per call.  Each of `names` must
    match exactly one kernel, launched once per call, and the window must
    hold no other kernel.  (None, None) where the window was event-timed
    (no kernel seen)."""
    if not by_kernel:
        return None, None
    phase_ms, per_call = {}, 0.0
    for p in names:
        hits = [key for key in by_kernel if p in key]
        if len(hits) != 1 or by_kernel[hits[0]][1] != 1.0:
            raise AssertionError(f"{p}: expected one kernel launched once "
                                 f"per call, profiler saw {hits} "
                                 f"{[by_kernel[h] for h in hits]}")
        phase_ms[p], count = by_kernel[hits[0]]
        per_call += count
    others = [k for k in by_kernel if not any(p in k for p in names)]
    if others:
        raise AssertionError(f"kernels other than {names} in the window: "
                             f"{others}")
    return phase_ms, per_call


def _ssd_scratch_bytes(x, b_in, chunk: int) -> int:
    """The f32 scratch a call allocates: each chunk's [P, N] state and its
    total decay, [B, H, NC, P N + 1], NC = ceil(S / chunk)."""
    b, s, h, p = x.shape
    return 4 * b * h * -(-s // chunk) * (p * b_in.shape[2] + 1)


def _wkv_scratch_bytes(r, v, chunk: int) -> int:
    """The f32 scratch a call allocates: each chunk's [K, V] state and
    its [K] total decay, [B, H, NC, K, V + 1], NC = ceil(S / chunk)."""
    b, s, h, kd = r.shape
    return 4 * b * h * -(-s // chunk) * kd * (v.shape[3] + 1)


def _rwkv_bound(r, v, state):
    """Bytes: r, k, v, u in their type and w in f32 read once, the state
    read once when given, out written once in r's type and the final
    state in f32.  Operations: the recurrence's 5 f32 operations per
    (t, h, k, v) (decay, outer product, add, and the r . state
    multiply-add), the least the function needs, at the f32 CUDA-core
    peak: the state and decays are f32 in the reference."""
    b, s, h, kd = r.shape
    vd = v.shape[3]
    elem = r.element_size()
    n_bytes = (elem * (2 * r.numel() + 2 * v.numel() + h * kd)
               + 4 * r.numel()
               + 4 * b * h * kd * vd * (2 if state is not None else 1))
    return bound_ms(n_bytes, 5 * b * s * h * kd * vd)


def phase_lm_kernels():
    """flash_attention, mamba2_ssd and rwkv6_wkv against their plain
    versions at the serve paths' shapes (zamba2: 32 heads of 80, 80 SSD
    heads of 64 with a 64-wide state; starcoder2: a GQA group of 12 with
    heads of 128; rwkv6-3b: 40 WKV heads of 64)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wkv
    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    rows = []
    bf16, f32 = torch.bfloat16, torch.float32
    for label, sq, h, hkv, dh, dtype in (
            ("zamba2 bf16 S=1024", 1024, 32, 32, 80, bf16),
            ("zamba2 bf16 S=777", 777, 32, 32, 80, bf16),
            ("starcoder2 bf16 S=1024", 1024, 24, 2, 128, bf16),
            ("zamba2 f32 S=1024", 1024, 32, 32, 80, f32)):
        q = randn(1, sq, h, dh, dtype=dtype)
        k = randn(1, sq, hkv, dh, dtype=dtype)
        v = randn(1, sq, hkv, dh, dtype=dtype)
        tol = 2e-2 if dtype == bf16 else 2e-5
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = max_err(got.float(), ref.attention(q, k, v).float())
        if not err <= tol:
            raise AssertionError(f"flash_attention {label}: {err} > {tol}")
        run = (lambda: fa.flash_attention(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=h != hkv), 200,
            label=f"sdpa {label}")
        b, by = _attn_bound(q, k, v)
        rows.append(dict(
            name=f"flash_attention[{label}]", source=fa.SOURCE, tol=tol,
            shape=f"q{tuple(q.shape)} kv{tuple(k.shape)}", max_abs_err=err,
            ms=device_ms(run, 20, label=f"flash_attention {label}"),
            call_ms=call_ms(run, 20),
            plain_ms=device_ms(lambda: ref.attention(q, k, v), 10,
                               label=f"plain attention {label}"),
            bound_ms=b, bound_by=by, library_ms=library))

    h, p, n = 80, 64, 64
    for s, dtype, with_state, iters in (
            (1024, bf16, False, 20), (1024, bf16, True, 20),
            (777, bf16, False, 20), (777, bf16, True, 20),
            (16384, bf16, False, 3), (1024, f32, False, 20)):
        x = randn(1, s, h, p, dtype=dtype)
        dt = F.softplus(randn(1, s, h))
        a = -torch.ones(h, device=dev)        # zamba2's a_log init is 0
        b_in, c_in = (randn(1, s, n, dtype=dtype),
                      randn(1, s, n, dtype=dtype))
        d = torch.ones(h, device=dev, dtype=dtype)
        st = 0.1 * randn(1, h, p, n) if with_state else None
        args = (x, dt, a, b_in, c_in, d, st)
        got = ssd.mamba2_ssd(*args, chunk=256)
        torch.cuda.synchronize()
        want = ref.mamba2_ssd(*args, chunk=256)
        # bf16 y: both round an f32 result to bf16 once, 2e-2 absolute and
        # relative; f32 y and the f32 state at 2e-3 (the reference's
        # tolerance)
        tol_y = 2e-2 if dtype == bf16 else 2e-3
        ok_y = ((got[0].float() - want[0].float()).abs()
                <= tol_y + tol_y * want[0].float().abs()).all()
        ok_s = ((got[1] - want[1]).abs() <= 2e-3 + 2e-3 * want[1].abs()).all()
        finite = bool(torch.isfinite(got[0]).all()
                      and torch.isfinite(got[1]).all())
        err = max(max_err(got[0].float(), want[0].float()),
                  max_err(got[1], want[1]))
        label = (f"zamba2 {'bf16' if dtype == bf16 else 'f32'} S={s}"
                 f"{' +state' if with_state else ''}")
        if not (ok_y and ok_s and finite):
            raise AssertionError(f"mamba2_ssd {label}: max error {err}, "
                                 f"finite {finite}")
        run = (lambda: ssd.mamba2_ssd(*args, chunk=256))
        b, by = _ssd_bound(x, b_in, st)
        kernels = {}
        ms = device_ms(run, iters, label=f"mamba2_ssd {label}",
                       by_kernel=kernels, expect=len(SSD_PHASES))
        phase_ms, per_call = _phases(kernels, SSD_PHASES)
        rows.append(dict(
            name=f"mamba2_ssd[{label}]", source=ssd.SOURCE,
            tol=f"y {tol_y:g} + {tol_y:g}|y|, state 2e-3 + 2e-3|s|",
            shape=f"x{tuple(x.shape)} n{n}", max_abs_err=err,
            ms=ms, call_ms=call_ms(run, iters),
            plain_ms=device_ms(lambda: ref.mamba2_ssd(*args, chunk=256),
                               2 if s > 4096 else 5, warmup=1,
                               label=f"plain mamba2_ssd {label}"),
            bound_ms=b, bound_by=by, library_ms=None,
            kernel_launches_per_call=per_call, phase_ms=phase_ms,
            scratch_bytes=_ssd_scratch_bytes(x, b_in, ssd.CHUNK),
            note="ms sums the device time of the call's three kernels "
                 "(chunk states, state scan, output); the launches per "
                 "call and phase_ms are counted in the profiler window, "
                 "null where it was event-timed"))

    # rwkv6_wkv at rwkv6-3b's widths: r, k, v, u in the activation type,
    # w f32 as the model makes it (exp(-exp(N(0, 0.5) - 1)), log w in about
    # [-1, -0.1], as at random init), the f32 state from a cache
    h, kd = 40, 64
    for s, dtype, with_state, log_w, iters in (
            (1024, bf16, False, None, 20), (777, bf16, False, None, 20),
            (777, bf16, True, None, 20), (16384, bf16, False, None, 3),
            (1024, f32, False, None, 20), (1024, bf16, True, -1.5, 20)):
        r, k, v = (randn(1, s, h, kd, dtype=dtype) for _ in range(3))
        if log_w is None:
            w = torch.exp(-torch.exp(0.5 * randn(1, s, h, kd) - 1.0))
        else:
            w = torch.full((1, s, h, kd), math.exp(log_w), device=dev)
        u = randn(h, kd, dtype=dtype)
        st = 0.1 * randn(1, h, kd, kd) if with_state else None
        args = (r, k, v, w, u, st)
        got = wkv.rwkv6_wkv(*args)
        torch.cuda.synchronize()
        # the strong-decay row is held against the sequential recurrence
        oracle = ref.rwkv6_wkv if log_w is None else ref.rwkv6_wkv_scan
        want = oracle(*args)
        if dtype == f32:
            tol = "2e-4"
            ok = all(((g - x).abs() <= 2e-4 + 2e-4 * x.abs()).all()
                     for g, x in zip(got, want))
        else:
            tol = "out 2e-2 + 2e-2|y|, state 2e-3 + 2e-3|s|"
            ok = (((got[0].float() - want[0].float()).abs()
                   <= 2e-2 + 2e-2 * want[0].float().abs()).all()
                  and ((got[1] - want[1]).abs()
                       <= 2e-3 + 2e-3 * want[1].abs()).all())
        finite = bool(torch.isfinite(got[0]).all()
                      and torch.isfinite(got[1]).all())
        err = max(max_err(got[0].float(), want[0].float()),
                  max_err(got[1], want[1]))
        label = (f"rwkv6 {'bf16' if dtype == bf16 else 'f32'} S={s}"
                 f"{' +state' if with_state else ''}"
                 f"{f' log w={log_w}' if log_w is not None else ''}")
        if not (ok and finite):
            raise AssertionError(f"rwkv6_wkv {label}: max error {err}, "
                                 f"finite {finite}")
        run = (lambda: wkv.rwkv6_wkv(*args))
        b, by = _rwkv_bound(r, v, st)
        kernels = {}
        ms = device_ms(run, iters, label=f"rwkv6_wkv {label}",
                       by_kernel=kernels, expect=len(WKV_PHASES))
        phase_ms, per_call = _phases(kernels, WKV_PHASES)
        rows.append(dict(
            name=f"rwkv6_wkv[{label}]", source=wkv.SOURCE, tol=tol,
            shape=f"r{tuple(r.shape)} v{tuple(v.shape)}", max_abs_err=err,
            ms=ms, call_ms=call_ms(run, iters),
            plain_ms=device_ms(lambda: ref.rwkv6_wkv(*args), 2, warmup=1,
                               label=f"plain rwkv6_wkv {label}"),
            bound_ms=b, bound_by=by, library_ms=None,
            kernel_launches_per_call=per_call, phase_ms=phase_ms,
            scratch_bytes=_wkv_scratch_bytes(r, v, wkv.CHUNK),
            note="ms sums the device time of the call's three kernels "
                 "(chunk states, state scan, output); the launches per "
                 "call and phase_ms are counted in the profiler window, "
                 "null where it was event-timed"))
    for r in rows:
        r["source"] = str(Path(r["source"]).relative_to(ROOT))
        log("kernel", **{k: (f"{v:.6g}" if isinstance(v, float) else v)
                         for k, v in r.items()})
    return rows


# ---------------------------------------------------------------------------
def _gs2_factory(m):
    import numpy as np
    from repro_torch.core import LambdaModel
    from repro_torch.uq import gs2_proxy

    def factory():
        solver = gs2_proxy.make_solver(m=m)

        def fn(parameters, config):
            g, f = solver(np.asarray(parameters[0], np.float32))
            return [[g, f]]

        return LambdaModel("gs2", fn, 7, 2,
                           warmup_fn=lambda: solver(np.full(7, 0.5,
                                                            np.float32)))
    return factory


def _partitioned_dataset(n, d, seed=0):
    """The recipe of benchmarks/gp_scale.py `_dataset`, at d = 7."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.3 * x[:, 1] - 0.1 * x[:, 2] * x[:, 3]
         + 0.05 * rng.standard_normal(n)).astype(np.float32)[:, None]
    return x, y


def phase_main():
    import numpy as np
    import torch
    from repro_torch.core import EvalRequest, Executor, metrics
    from repro_torch.kernels import gp_kernel
    from repro_torch.sched import PackingPolicy, SurrogateOffload
    from repro_torch.uq import engine as engine_lib
    from repro_torch.uq import gp as gp_lib
    from repro_torch.uq import gs2_proxy, qoi, sampling

    out = {}
    thetas = sampling.latin_hypercube(N_SIMS, seed=11)
    backlog = sampling.latin_hypercube(N_BACKLOG, seed=12)
    torch.cuda.synchronize()

    gp_kernel.reset_launches()
    gp_lib.predict_batch_shapes.clear()
    t_main = time.perf_counter()

    # 1-2. GS2 solves on the executor: persistent workers, then naive
    factory = _gs2_factory(gs2_proxy.DEFAULT_RESOLUTION)
    t0 = time.perf_counter()
    with Executor({"gs2": factory}, n_workers=N_WORKERS,
                  persistent_servers=True, predictor="gp",
                  straggler_factor=6.0) as ex:
        reqs = [EvalRequest("gs2", [t.tolist()]) for t in thetas]
        results = ex.run_all(reqs, timeout=900)
        s = metrics.summarize("gs2", "hq", ex.records())
        predictor = ex.predictor
    wall = time.perf_counter() - t0
    if len(results) != N_SIMS or any(r.status != "ok" for r in results):
        raise AssertionError("GS2 executor run did not complete every task")
    if predictor.n_fits < 1:
        raise AssertionError("the GP runtime predictor never fitted")
    init_share = 1 - s.total_compute / max(s.total_cpu_time, 1e-9)
    out["executor_hq"] = dict(wall_s=wall, cpu_s=s.total_cpu_time,
                              compute_s=s.total_compute,
                              init_share=init_share,
                              predictor_fits=predictor.n_fits)
    log("main.executor", mode="persistent", tasks=N_SIMS, wall_s=f"{wall:.3f}",
        cpu_s=f"{s.total_cpu_time:.3f}", init_share=f"{init_share:.4f}",
        predictor_fits=predictor.n_fits)

    t0 = time.perf_counter()
    with Executor({"gs2": factory}, n_workers=N_WORKERS,
                  persistent_servers=False) as ex:
        naive = ex.run_all([EvalRequest("gs2", [t.tolist()])
                            for t in thetas[:N_NAIVE]], timeout=900)
        sn = metrics.summarize("gs2", "naive", ex.records())
        init_ts = [r.cpu_time - r.compute_t for r in ex.records()]
    wall_n = time.perf_counter() - t0
    if any(r.status != "ok" for r in naive):
        raise AssertionError("naive executor run failed")
    init_share_n = 1 - sn.total_compute / max(sn.total_cpu_time, 1e-9)
    out["executor_naive"] = dict(
        wall_s=wall_n, cpu_s=sn.total_cpu_time, init_share=init_share_n,
        fresh_server_s_median=float(np.median(init_ts)),
        fresh_server_s_max=float(np.max(init_ts)))
    log("main.executor", mode="fresh-server", tasks=N_NAIVE,
        wall_s=f"{wall_n:.3f}", cpu_s=f"{sn.total_cpu_time:.3f}",
        init_share=f"{init_share_n:.4f}",
        fresh_server_median_s=f"{np.median(init_ts):.4f}")

    by_id = {r.task_id: r.value[0] for r in results}
    y = np.array([by_id[r.task_id] for r in reqs], np.float64)
    if y.shape != (N_SIMS, 2) or not np.isfinite(y).all():
        raise AssertionError(f"GS2 outputs malformed: {y.shape}")

    # 3. GP surrogate on (theta, [growth, freq])
    t0 = time.perf_counter()
    post = gp_lib.fit(thetas, y, steps=FIT_STEPS)
    mean, var = gp_lib.predict(post, thetas[:16])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_err = float(np.max(np.abs(mean.cpu().numpy() - y[:16])))
    if not (np.isfinite(train_err) and torch.isfinite(var).all()):
        raise AssertionError("GP fit produced non-finite predictions")
    out["gp_fit"] = dict(seconds=fit_s, n=N_SIMS, steps=FIT_STEPS,
                         max_train_err=train_err)
    log("main.gp_fit", seconds=f"{fit_s:.3f}", max_train_err=f"{train_err:.5f}")

    # 4a. re-cost a 100k backlog through the packing policy (mean + sd)
    backlog_reqs = [EvalRequest("gs2", [t.tolist()]) for t in backlog]
    pol = PackingPolicy(predictor, risk_lambda=1.0)
    t0 = time.perf_counter()
    costs = np.asarray(pol.costs(backlog_reqs))
    recost_s = time.perf_counter() - t0
    if costs.shape != (N_BACKLOG,) or not (np.isfinite(costs).all()
                                           and (costs > 0).all()):
        raise AssertionError("backlog costs malformed")
    out["recost"] = dict(tasks=N_BACKLOG, seconds=recost_s,
                         tasks_per_s=N_BACKLOG / recost_s,
                         predictor_n=int(predictor._post.x.shape[0]))
    log("main.recost", tasks=N_BACKLOG, seconds=f"{recost_s:.3f}",
        tasks_per_s=f"{N_BACKLOG / recost_s:.0f}")

    # 4b. trust-score the same backlog through the offload router
    offload = SurrogateOffload(post, model_name="gs2", runtime_budget_s=1.0,
                               sd_threshold=0.5)
    t0 = time.perf_counter()
    sds = offload.trust_sd(backlog)
    trust_s = time.perf_counter() - t0
    decided = [offload.decide(r, 5.0) for r in backlog_reqs[:64]]
    served = offload.evaluate(backlog_reqs[0].parameters)
    if sds.shape != (N_BACKLOG,) or not np.isfinite(sds).all():
        raise AssertionError("trust sds malformed")
    if len(served[0]) != 2 or not np.isfinite(served[0]).all():
        raise AssertionError("surrogate evaluation malformed")
    out["trust"] = dict(tasks=N_BACKLOG, seconds=trust_s,
                        trusted_share=float(np.mean(sds <= 0.5)),
                        offloaded_of_64=int(sum(decided)))
    log("main.trust", tasks=N_BACKLOG, seconds=f"{trust_s:.3f}",
        trusted_share=f"{np.mean(sds <= 0.5):.4f}",
        offloaded_of_64=sum(decided))

    # 4c. partitioned engine at n = 8,192 on the same backlog, mapped
    # from the GS2 box onto the dataset's [-2, 2]^7
    x_p, y_p = _partitioned_dataset(N_PARTITIONED, 7)
    t0 = time.perf_counter()
    part = engine_lib.fit_engine(x_p, y_p, "partitioned", steps=100,
                                 expert_cap=128)
    torch.cuda.synchronize()
    part_fit_s = time.perf_counter() - t0
    lo = np.array([r[1] for r in sampling.GS2_PARAM_RANGES])
    hi = np.array([r[2] for r in sampling.GS2_PARAM_RANGES])
    xq = (-2.0 + 4.0 * (backlog - lo) / (hi - lo)).astype(np.float32)
    t0 = time.perf_counter()
    pm, pv = part.predict_batch(xq)
    torch.cuda.synchronize()
    part_s = time.perf_counter() - t0
    truth = np.sin(xq[:, 0]) + 0.3 * xq[:, 1] - 0.1 * xq[:, 2] * xq[:, 3]
    part_rmse = float(np.sqrt(np.mean((pm.cpu().numpy()[:, 0] - truth) ** 2)))
    if not (torch.isfinite(pm).all() and torch.isfinite(pv).all()
            and part_rmse < 0.5):
        raise AssertionError(f"partitioned predictions off: rmse {part_rmse}")
    out["partitioned"] = dict(n=N_PARTITIONED, experts=len(part.experts),
                              fit_s=part_fit_s, predict_s=part_s,
                              tasks=N_BACKLOG, rmse_vs_truth=part_rmse)
    log("main.partitioned", n=N_PARTITIONED, experts=len(part.experts),
        fit_s=f"{part_fit_s:.3f}", predict_s=f"{part_s:.3f}",
        rmse=f"{part_rmse:.4f}")

    # 5. QoI on the surrogate: direct 8x8 quadrature and BQ
    def surrogate(x):
        m_, _ = gp_lib.predict(post, x[None])
        m_ = m_.cpu().numpy()
        return float(m_[0, 0]), float(m_[0, 1])

    t0 = time.perf_counter()
    direct = qoi.quadrature(surrogate, thetas[0], n_ky=8, n_theta0=8)
    bq = qoi.bayesian_quadrature(surrogate, thetas[0], n_init=6,
                                 n_adaptive=8)
    qoi_s = time.perf_counter() - t0
    if not (math.isfinite(direct.value) and math.isfinite(bq.value)
            and direct.n_evals == 64 and bq.n_evals == 14):
        raise AssertionError("QoI malformed")
    out["qoi"] = dict(direct=direct.value, bq=bq.value,
                      bq_uncertainty=bq.uncertainty, seconds=qoi_s)
    log("main.qoi", direct=f"{direct.value:.6f}", bq=f"{bq.value:.6f}",
        bq_sd=f"{bq.uncertainty:.6f}", seconds=f"{qoi_s:.3f}")

    torch.cuda.synchronize()
    out["main_path_s"] = time.perf_counter() - t_main
    log("main.total", seconds=f"{out['main_path_s']:.3f}")
    launches = dict(gp_kernel.launches)
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    log("main.launches", **launches)
    # batched-predict launches per (training rows, query bucket); the
    # partitioned engine's keys are ("part", experts, rows per expert,
    # bucket)
    shapes = {" ".join(map(str, k)): v
              for k, v in sorted(gp_lib.predict_batch_shapes.items(),
                                 key=lambda kv: str(kv[0]))}
    out["predict_batch_shapes"] = shapes
    log("main.predict_batch_shapes", **{k.replace(" ", "_"): v
                                        for k, v in shapes.items()})

    # the card's batched predict against the port on the CPU, same
    # posterior (1e-4: same f32 formulas, different summation order)
    rows = backlog[:1024]
    card_m, card_v = gp_lib.predict_batch(post, rows)
    cpu_post = gp_lib.posterior_from_numpy(gp_lib.posterior_to_numpy(post),
                                           "cpu")
    cpu_m, cpu_v = gp_lib.predict_batch(cpu_post, rows)
    scale_m = np.maximum(np.abs(cpu_m.numpy()), 1.0)
    err_m = float(np.max(np.abs(card_m.cpu().numpy() - cpu_m.numpy())
                         / scale_m))
    err_v = float(np.max(np.abs(card_v.cpu().numpy() - cpu_v.numpy())
                         / np.maximum(np.abs(cpu_v.numpy()), 1.0)))
    if not (err_m <= 1e-4 and err_v <= 1e-4):
        raise AssertionError(f"card vs CPU predict_batch: mean {err_m}, "
                             f"var {err_v} > 1e-4")
    out["card_vs_cpu"] = dict(mean_err=err_m, var_err=err_v)
    log("main.card_vs_cpu", mean_err=f"{err_m:.3g}", var_err=f"{err_v:.3g}")

    # the fit's step profiled, and K's gradient the port's way against the
    # plain autograd, at the main fit's data
    prof = fit_step_profile(thetas, y)
    out["gp_fit"]["step_profile"] = prof
    step, kg = prof["step"], prof["k_grad"]
    log("main.gp_fit", profile_steps=5, kernels_per_step=step["kernels"],
        whole_counts=step["whole_counts"],
        device_ms_per_step=f"{step['device_ms']:.6g}",
        host_ms_per_step=f"{step['host_ms']:.6g}",
        **{f"k_grad_{name}_{key}": (f"{v[key]:.6g}"
                                    if isinstance(v[key], float) else v[key])
           for name, v in kg.items()
           for key in ("kernels", "device_ms", "host_ms", "whole_counts")})
    return out, launches, post, backlog


# ---------------------------------------------------------------------------
# the paper's scheduling comparison through the port (phase `sim`)
SIM_SEED = 7                  # tests/test_scheduler.py::_run's seed
SIM_TRACE_TASKS = 2_048
SIM_WORKERS = 64
SIM_PREFIX = 256
SIM_BUDGET_S = 30.0           # benchmarks/surrogate_offload.py's budget
ADAPTIVE_REQUESTS = 64
ADAPTIVE_WORKERS = 8
MCMC_CHAINS = 4
MCMC_STEPS = 200
# the differential tests' tolerance for a GP on either side of a
# comparison: the latent trust variance (sd^2) within 1e-4, decisions
# equal where both variances lie farther than that from threshold^2, at
# most 5% of the tasks left out of the comparison
SIM_VAR_TOL = 1e-4
SIM_LEFT_OUT = 0.05


def _offload_trace(thetas, expensive, seed=SIM_SEED):
    """The trace recipe of benchmarks/surrogate_offload.py `make_trace`
    (exponential inter-arrivals of mean 5 s; expensive tasks at 120 s,
    the rest 4 s; lognormal sigma 0.3), with `thetas` (GS2 inputs) as the
    tasks' parameters in place of its synthetic 2-D draws.  The recipe
    draws which tasks are expensive (40%) independently of theta, which
    leaves a runtime predictor nothing to learn; here `expensive` (one
    bool per theta) decides it."""
    import numpy as np
    from repro_torch.cluster import TraceTask
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for theta, dear in zip(thetas, expensive):
        t += float(rng.exponential(5.0))
        base = 120.0 if dear else 4.0
        runtime = base * float(np.exp(0.3 * rng.standard_normal()))
        out.append(TraceTask(t=t, runtime=runtime, model_name="gs2",
                             time_request=base,
                             parameters=[[float(v) for v in theta]]))
    return out


def _cluster_run(trace, post, thr, profile_device=False):
    """simulate_cluster on hq: SJF over the GP runtime predictor, the GP
    surrogate offload on the broker, the metrics registry and a tracer
    attached; the invariants checked on the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.chaos import InvariantChecker
    from repro_torch.cluster import Broker, simulate_cluster
    from repro_torch.core import backends
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.sched import SurrogateOffload, make_predictor
    from repro_torch.sched.offload import record_decisions

    off = SurrogateOffload(post, model_name="gs2",
                           runtime_budget_s=SIM_BUDGET_S, sd_threshold=thr)
    decisions = record_decisions(off)
    broker = Broker(policy="sjf", predictor=make_predictor("gp"),
                    surrogate=off)
    registry, tracer = MetricsRegistry(), Tracer()
    on_card = post.x.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    # device activity only: a CPU-side trace of every operator over
    # seconds of host work costs more to take and read than the run
    prof = (profile(activities=[ProfilerActivity.CUDA])
            if profile_device else None)
    t0 = time.perf_counter()
    if prof is not None:
        prof.__enter__()
    try:
        res = simulate_cluster(backends.get("hq"), trace, broker=broker,
                               n_workers=SIM_WORKERS, seed=SIM_SEED,
                               registry=registry, tracer=tracer)
        if on_card:
            torch.cuda.synchronize()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    report = InvariantChecker().check(
        records=res.records, allocations=res.allocations,
        events=tracer.events(),
        expected_tasks=[f"trace-{i}" for i in range(len(trace))])
    if not report.ok:
        raise AssertionError(f"cluster invariants: {report.violations[:5]}")
    if len(res.records) != len(trace) or \
            any(r.status != "ok" for r in res.records):
        raise AssertionError("a cluster task did not end ok")
    out = dict(tasks=len(trace), wall_s=wall,
               n_fits=broker.predictor.n_fits,
               offloaded=off.stats().n_offloaded,
               makespan_s=res.summary()["makespan"],
               node_seconds=res.summary()["node_seconds"],
               registry_samples=registry.n_samples,
               invariant_measures=report.measures)
    if prof is not None:
        busy = _device_busy_ms(prof)
        out["device_busy_ms"] = busy if busy > 0 else None
        out["device_idle_share"] = (1 - busy / (wall * 1e3) if busy > 0
                                    else None)
    return res, out, decisions


def _compare_decisions(card, cpu, thr):
    """Card against CPU, the differential tests' rule: trust variances
    within SIM_VAR_TOL, decisions equal away from the threshold."""
    compared = mismatched = 0
    worst = 0.0
    for tid, (sd_a, dec_a) in card.items():
        sd_b, dec_b = cpu[tid]
        if sd_a is None and sd_b is None:
            if dec_a or dec_b:
                mismatched += 1
            compared += 1
        elif sd_a is not None and sd_b is not None:
            worst = max(worst, abs(sd_a ** 2 - sd_b ** 2))
            if min(abs(sd_a ** 2 - thr ** 2),
                   abs(sd_b ** 2 - thr ** 2)) > SIM_VAR_TOL:
                mismatched += dec_a != dec_b
                compared += 1
    return dict(compared=compared, mismatched=mismatched,
                left_out=len(card) - compared, max_var_err=worst)


def _quickstart_gp_factory():
    """examples/quickstart_torch.py's GP surrogate model factory."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.gp_model_factory


def _table3_bands(cells):
    """The paper's claims as tests/test_scheduler.py:57-120 holds them."""
    def c(bench, backend, q):
        return cells[f"{bench}|{backend}|{q}"]

    failed = []
    for q in (2, 10):
        red = 1 - c("gs2", "hq", q)["makespan_s"] / \
            c("gs2", "slurm", q)["makespan_s"]
        if not 0.28 <= red <= 0.48:
            failed.append(f"gs2 makespan reduction {red} at q={q}")
        if c("gs2", "umb-slurm", q)["makespan_s"] < \
                0.95 * c("gs2", "slurm", q)["makespan_s"]:
            failed.append(f"umb-slurm gains over slurm at q={q}")
    for bench, floor in (("gs2", 1e3), ("eigen-5000", 1e3),
                         ("eigen-100", 300.0)):
        ratio = c(bench, "slurm", 2)["median_overhead_s"] / \
            max(c(bench, "hq", 2)["median_overhead_s"], 1e-9)
        if ratio < floor:
            failed.append(f"{bench} overhead ratio {ratio} < {floor}")
    speed = c("eigen-100", "slurm", 2)["makespan_s"] / \
        c("eigen-100", "hq", 2)["makespan_s"]
    if not 2.0 <= speed <= 6.0:
        failed.append(f"eigen-100 hq speed-up {speed}")
    if not c("eigen-100", "hq", 2)["cpu_s"] > \
            c("eigen-100", "slurm", 2)["cpu_s"]:
        failed.append("hq does not lose CPU time on eigen-100")
    if not c("gs2", "hq", 10)["cpu_s"] < c("gs2", "slurm", 10)["cpu_s"]:
        failed.append("hq does not save CPU time on gs2 at q=10")
    h, s = c("eigen-100", "hq", 2)["slr"], c("eigen-100", "slurm", 2)["slr"]
    if not (h < 2.0 and s > 2.0 * h):
        failed.append(f"slr ordering hq={h} slurm={s}")
    wins = sum(c(b, "hq", q)["makespan_s"] < c(b, "slurm", q)["makespan_s"]
               for b in ("eigen-100", "eigen-5000", "gs2", "gp")
               for q in (2, 10))
    if wins < 7:
        failed.append(f"hq first in {wins} of 8 cells")
    if failed:
        raise AssertionError("Table III bands: " + "; ".join(failed))
    return wins


def phase_sim(post, backlog):
    """The paper's scheduling comparison and the cluster stack through
    the port, reusing `main`'s GS2 posterior and backlog: Table III, the
    cluster simulation with the GP on the card (and a prefix against the
    port on the CPU), adaptive delegation on the incremental and
    partitioned engines, and the LoadBalancer facade with MCMC.  Each
    path's GP launches are counted from zero."""
    import numpy as np
    import torch
    from repro_torch import device
    from repro_torch.configs import workloads
    from repro_torch.core import (EvalRequest, Executor, LoadBalancer,
                                  backends, eval_records, metrics, simulate)
    from repro_torch.kernels import gp_kernel
    from repro_torch.sched import SurrogateOffload
    from repro_torch.uq import adaptive, gs2_proxy, mcmc, sampling
    from repro_torch.uq import engine as engine_lib
    from repro_torch.uq import gp as gp_lib
    from repro_torch.uq.eigen import EigenModel

    out, launches = {}, {}
    t_phase = time.perf_counter()

    # 1. Table III: the port's own GS2 runtime table, solved on the card
    t_block = t0 = time.perf_counter()
    gs2 = workloads.make_workload("gs2")
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    rts = np.asarray(gs2.runtimes)
    out["gs2_table"] = dict(solves=gs2.n_tasks, seconds=table_s,
                            runtime_min_s=float(rts.min()),
                            runtime_median_s=float(np.median(rts)),
                            runtime_max_s=float(rts.max()))
    log("sim.gs2_table", solves=gs2.n_tasks, seconds=f"{table_s:.3f}",
        runtime_min_s=f"{rts.min():.1f}",
        runtime_median_s=f"{np.median(rts):.1f}",
        runtime_max_s=f"{rts.max():.1f}")
    cells = {}
    for bench in workloads.BENCHMARKS:
        w = gs2 if bench == "gs2" else workloads.make_workload(bench)
        for q in workloads.QUEUE_DEPTHS:
            for backend in ("slurm", "hq", "umb-slurm"):
                s = metrics.summarize(bench, backend, eval_records(simulate(
                    backends.get(backend), w, q, seed=SIM_SEED)))
                cell = dict(makespan_s=s.makespan, cpu_s=s.total_cpu_time,
                            median_overhead_s=s.overhead_stats["median"],
                            slr=s.slr)
                cells[f"{bench}|{backend}|{q}"] = cell
                log("sim.table3", bench=bench, q=q, backend=backend,
                    makespan_s=repr(cell["makespan_s"]),
                    cpu_s=repr(cell["cpu_s"]),
                    median_overhead_s=repr(cell["median_overhead_s"]))
    wins = _table3_bands(cells)
    block_s = time.perf_counter() - t_block
    out["table3"] = dict(cells=cells, hq_first_cells=wins, seconds=block_s)
    log("sim.table3", bands="held", hq_first_cells=f"{wins}/8",
        seconds=f"{block_s:.3f}")

    # 2. the cluster simulation with the GP on the card.  The expensive
    # tasks are the 40% (the recipe's share) of highest growth rate under
    # main's posterior, so a task's runtime depends on its theta and the
    # GP runtime predictor can learn which ones exceed the budget.  The
    # trust threshold is the median trust sd over the trace, so about
    # half the tasks that pass the cost gate are trusted
    t_block = time.perf_counter()
    thetas = backlog[:SIM_TRACE_TASKS]
    growth = gp_lib.predict_batch(post, thetas)[0][:, 0].cpu().numpy()
    expensive = growth >= np.quantile(growth, 0.6)
    trace = _offload_trace(thetas, expensive)
    thr = float(np.median(SurrogateOffload(post).trust_sd(thetas)))
    gp_kernel.reset_launches()
    _, cl, dec = _cluster_run(trace, post, thr)
    launches["cluster"] = dict(gp_kernel.launches)
    block_s = time.perf_counter() - t_block
    checked = [i for i, t in enumerate(trace)
               if dec.get(f"trace-{i}", (None,))[0] is not None]
    n_dear = int(expensive.sum())
    cl.update(expensive=n_dear, trust_checked=len(checked),
              trust_checked_expensive=int(expensive[checked].sum()))
    if not (cl["trust_checked_expensive"] >= n_dear / 4
            and cl["offloaded"] > 0):
        raise AssertionError(f"the cost gate passed "
                             f"{cl['trust_checked_expensive']} of {n_dear} "
                             f"expensive tasks; offloaded {cl['offloaded']}")
    out["cluster"] = dict(cl, sd_threshold=thr, seconds=block_s,
                          launches=launches["cluster"])
    log("sim.cluster", tasks=len(trace), workers=SIM_WORKERS,
        wall_s=f"{cl['wall_s']:.3f}", seconds=f"{block_s:.3f}",
        n_fits=cl["n_fits"], expensive=n_dear,
        trust_checked=len(checked),
        trust_checked_expensive=cl["trust_checked_expensive"],
        offloaded=cl["offloaded"], sd_threshold=repr(thr),
        makespan_s=repr(cl["makespan_s"]), invariants="held",
        **{f"launches_{k}": v for k, v in launches["cluster"].items()})

    # ... its first SIM_PREFIX tasks on the card (profiled) and through
    # the port on the CPU, same posterior
    t_block = time.perf_counter()
    prefix = trace[:SIM_PREFIX]
    gp_kernel.reset_launches()
    _, card, card_dec = _cluster_run(prefix, post, thr, profile_device=True)
    launches["cluster_prefix"] = dict(gp_kernel.launches)
    device.set_device("cpu")
    try:
        cpu_post = gp_lib.posterior_from_numpy(
            gp_lib.posterior_to_numpy(post), "cpu")
        _, cpu, cpu_dec = _cluster_run(prefix, cpu_post, thr)
    finally:
        device.set_device("cuda")
    cmp_ = _compare_decisions(card_dec, cpu_dec, thr)
    span = max(t.runtime for t in prefix)
    if cmp_["max_var_err"] > SIM_VAR_TOL or cmp_["mismatched"] or \
            cmp_["left_out"] > SIM_LEFT_OUT * len(prefix) or \
            abs(card["offloaded"] - cpu["offloaded"]) > cmp_["left_out"] or \
            abs(card["makespan_s"] - cpu["makespan_s"]) > span or \
            abs(card["n_fits"] - cpu["n_fits"]) > 1:
        raise AssertionError(f"cluster prefix card vs CPU: {cmp_}, "
                             f"card {card}, cpu {cpu}")
    block_s = time.perf_counter() - t_block
    out["cluster_prefix"] = dict(card=card, cpu=cpu, compare=cmp_,
                                 seconds=block_s,
                                 launches=launches["cluster_prefix"])
    log("sim.cluster_prefix", tasks=SIM_PREFIX, seconds=f"{block_s:.3f}",
        card_wall_s=f"{card['wall_s']:.3f}",
        cpu_wall_s=f"{cpu['wall_s']:.3f}",
        device_idle_share=(f"{card['device_idle_share']:.4f}"
                           if card.get("device_idle_share") is not None
                           else "not measured"),
        offloaded_card=card["offloaded"], offloaded_cpu=cpu["offloaded"],
        max_var_err=f"{cmp_['max_var_err']:.3g}",
        decisions_compared=cmp_["compared"], left_out=cmp_["left_out"])

    # 3. adaptive delegation: GS2 solves on persistent workers.  The
    # threshold is a quantile of the requests' gate sds under the engine
    # the stream starts from: the median on the incremental engine, whose
    # conditioning only lowers later sds; the 0.6 quantile on the
    # partitioned one, where an expert past its cap splits and the sds
    # it served rise (the median sent 0.73 of the requests to the
    # simulator on an H100)
    t_block = time.perf_counter()
    requests = sampling.latin_hypercube(ADAPTIVE_REQUESTS, seed=14)
    out["adaptive"] = {}
    with Executor({"gs2": _gs2_factory(gs2_proxy.DEFAULT_RESOLUTION)},
                  n_workers=ADAPTIVE_WORKERS, persistent_servers=True) as ex:
        for backend, q in (("incremental", 0.5), ("partitioned", 0.6)):
            _, var = engine_lib.as_engine(post, backend).predict_batch(
                requests)
            thr_a = float(np.quantile(np.sqrt(var.cpu().numpy()).max(1), q))
            gp_kernel.reset_launches()
            t0 = time.perf_counter()
            res = adaptive.evaluate_stream(ex, "gs2", post, requests,
                                           sd_threshold=thr_a,
                                           backend=backend)
            wall = time.perf_counter() - t0
            key = f"adaptive_{backend}"
            launches[key] = dict(gp_kernel.launches)
            share = res.n_sim_calls / ADAPTIVE_REQUESTS
            if not (0.25 <= share <= 0.75 and res.outputs.shape
                    == (ADAPTIVE_REQUESTS, 2)
                    and np.isfinite(res.outputs).all()):
                raise AssertionError(f"adaptive {backend}: simulator share "
                                     f"{share}, outputs {res.outputs.shape}")
            out["adaptive"][backend] = dict(
                requests=ADAPTIVE_REQUESTS, sd_quantile=q, sd_threshold=thr_a,
                simulator_share=share, wall_s=wall, launches=launches[key])
            log("sim.adaptive", backend=backend, requests=ADAPTIVE_REQUESTS,
                sd_quantile=q, sd_threshold=repr(thr_a),
                simulator_share=f"{share:.4f}",
                wall_s=f"{wall:.3f}",
                **{f"launches_{k}": v for k, v in launches[key].items()})

    block_s = time.perf_counter() - t_block
    out["adaptive"]["seconds"] = block_s
    log("sim.adaptive", seconds=f"{block_s:.3f}")

    # 4. the facade: the quickstart's mix, then MCMC on its surrogate
    t_block = time.perf_counter()
    lo = [r[1] for r in sampling.GS2_PARAM_RANGES]
    hi = [r[2] for r in sampling.GS2_PARAM_RANGES]
    with LoadBalancer("hq", n_workers=4) as lb:
        lb.register_model("eigen-100", lambda: EigenModel(100))
        lb.register_model("gp-surrogate", _quickstart_gp_factory())
        reqs = [EvalRequest("gp-surrogate", [t.tolist()])
                for t in sampling.latin_hypercube(16, seed=1)]
        reqs += [EvalRequest("eigen-100", [[0]]) for _ in range(8)]
        gp_kernel.reset_launches()
        t0 = time.perf_counter()
        results = lb.run_all(reqs, timeout=300)
        wall = time.perf_counter() - t0
        if any(r.status != "ok" for r in results):
            raise AssertionError("a quickstart request failed")
        s = metrics.summarize("quickstart", "hq", lb.records())
        observed = lb.evaluate("gp-surrogate",
                               [sampling.latin_hypercube(1, seed=2)[0]
                                .tolist()])[0]
        t0 = time.perf_counter()
        chains = mcmc.run_chains(
            lb.executor, "gp-surrogate",
            x0s=list(sampling.latin_hypercube(MCMC_CHAINS, seed=3)),
            bounds=list(zip(lo, hi)), observed=observed,
            n_steps=MCMC_STEPS, step_scale=0.05, sigma=0.05)
        mcmc_s = time.perf_counter() - t0
        launches["facade"] = dict(gp_kernel.launches)
    if any(c.n_evals != MCMC_STEPS + 1
           or not np.isfinite(c.samples).all() for c in chains):
        raise AssertionError("an MCMC chain is malformed")
    block_s = time.perf_counter() - t_block
    out["facade"] = dict(seconds=block_s,
        requests=len(reqs), wall_s=wall, cpu_s=s.total_cpu_time,
        overhead_s=s.scheduling_overhead,
        median_overhead_s=s.overhead_stats["median"], slr=s.slr,
        mcmc_chains=MCMC_CHAINS, mcmc_steps=MCMC_STEPS, mcmc_s=mcmc_s,
        accept_rates=[c.accept_rate for c in chains],
        launches=launches["facade"])
    log("sim.facade", requests=len(reqs), wall_s=f"{wall:.3f}",
        cpu_s=f"{s.total_cpu_time:.3f}",
        median_overhead_ms=f"{s.overhead_stats['median'] * 1e3:.3f}",
        slr=f"{s.slr:.3f}", seconds=f"{block_s:.3f}")
    log("sim.mcmc", chains=MCMC_CHAINS, steps=MCMC_STEPS,
        seconds=f"{mcmc_s:.3f}",
        accept_rates=",".join(f"{c.accept_rate:.3f}" for c in chains),
        **{f"launches_{k}": v for k, v in launches["facade"].items()})

    total = {}
    for per in launches.values():
        for k, v in per.items():
            total[k] = total.get(k, 0) + v
    missing = [k for k, v in total.items() if v < 1]
    if missing:
        raise AssertionError(f"GP kernels never launched in sim: {missing}")
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log("sim.total", seconds=f"{out['seconds']:.3f}",
        **{f"launches_{k}": v for k, v in total.items()})
    return out, total


def _serve_path(arch):
    """`arch` at its published widths through the port's Executor: a
    persistent server, then fresh servers.  Every LM kernel's launch
    counter is zeroed just before and read just after."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.launch import serve

    counters = {"flash_attention": fa, "mamba2_ssd": ssd, "rwkv6_wkv": wkv}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in counters.values():
        mod.reset_launches()
    out = {}
    t_serve = time.perf_counter()
    for mode, n_req, persistent in (("persistent", SERVE_REQUESTS, True),
                                    ("fresh-server", SERVE_FRESH, False)):
        r = serve.serve_benchmark(
            arch, reduced=False, n_requests=n_req,
            max_new=SERVE_MAX_NEW, n_workers=1, persistent=persistent,
            max_len=SERVE_MAX_LEN, min_prompt=SERVE_MIN_PROMPT, seed=0)
        torch.cuda.synchronize()
        s = r["summary"]
        init_ts = [rec.cpu_time - rec.compute_t for rec in r["records"]]
        init_share = 1 - s.total_compute / max(s.total_cpu_time, 1e-9)
        if r["tokens"] != n_req * SERVE_MAX_NEW:
            raise AssertionError(f"serve {arch} {mode}: {r['tokens']} "
                                 f"tokens")
        out[mode] = dict(
            requests=n_req, wall_s=r["wall"], cpu_s=s.total_cpu_time,
            compute_s=s.total_compute, init_share=init_share,
            tokens=r["tokens"], tokens_per_s=r["tokens"] / r["wall"],
            server_init_s=[t for t in init_ts if t > 0],
            makespan_s=s.makespan)
        log("serve", arch=arch, mode=mode, requests=n_req,
            wall_s=f"{r['wall']:.3f}", cpu_s=f"{s.total_cpu_time:.3f}",
            init_share=f"{init_share:.4f}",
            tokens_per_s=f"{r['tokens'] / r['wall']:.2f}",
            server_init_s=[f"{t:.3f}" for t in init_ts if t > 0])
    torch.cuda.synchronize()
    out["serve_s"] = time.perf_counter() - t_serve
    launches = {name: mod.launches[name] for name, mod in counters.items()}
    out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    lens = np.random.default_rng(0).integers(
        SERVE_MIN_PROMPT, SERVE_MAX_LEN // 2, SERVE_REQUESTS)
    out["prompt_lens"] = lens.tolist()
    log("serve.total", arch=arch, seconds=f"{out['serve_s']:.3f}",
        peak_device_gib=f"{out['peak_device_gib']:.2f}", **launches)
    return out, launches


def phase_serve():
    """zamba2-2.7b: the attention kernel must have launched, and every
    prefill runs the SSD kernel once per layer, so its counter must reach
    n_layers x requests (warm-ups add more)."""
    from repro_torch import configs
    out, launches = _serve_path(SERVE_ARCH)
    launches = {k: launches[k] for k in ("flash_attention", "mamba2_ssd")}
    if launches["flash_attention"] < 1:
        raise AssertionError("flash_attention never launched on the serve "
                             "path")
    need = configs.get(SERVE_ARCH).n_layers * (SERVE_REQUESTS + SERVE_FRESH)
    if launches["mamba2_ssd"] < need:
        raise AssertionError(f"mamba2_ssd launched {launches['mamba2_ssd']} "
                             f"times on the serve path, fewer than {need}")
    log("serve.launches", arch=SERVE_ARCH, mamba2_ssd=launches["mamba2_ssd"],
        need=need)
    return out, launches


def phase_serve_rwkv():
    """rwkv6-3b: every prefill runs the WKV kernel once per layer, so the
    counter must reach n_layers x requests (warm-ups add more)."""
    from repro_torch import configs
    out, launches = _serve_path(RWKV_ARCH)
    need = configs.get(RWKV_ARCH).n_layers * (SERVE_REQUESTS + SERVE_FRESH)
    if launches["rwkv6_wkv"] < need:
        raise AssertionError(f"rwkv6_wkv launched {launches['rwkv6_wkv']} "
                             f"times on the serve path, fewer than {need}")
    return out, {"rwkv6_wkv": launches["rwkv6_wkv"]}


def phase_serve_check():
    """Outside the timed windows, in f32 at full width: zamba2-2.7b 2
    groups (12 layers) deep and rwkv6-3b 4 layers deep.  (a)
    LMServer.generate's greedy tokens equal the argmax of repeated full
    forwards (tests/test_serve.py's check); (b) prefill logits on the card
    match the port on the CPU with the same weights, within 5e-3 relative
    to max(|x|, 1): the same f32 formulas, summed in other orders (cuBLAS
    and the kernels against the CPU's BLAS and the plain versions) over
    d_model 2560 and d_ff 8960-10240, through random-weight layers;
    1.3e-3 was measured on an H100 for zamba2."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model

    out = {}
    for arch, n_layers in (
            (SERVE_ARCH, 2 * configs.get(SERVE_ARCH).shared_attn_every),
            (RWKV_ARCH, 4)):
        cfg = configs.get(arch).replace(n_layers=n_layers, dtype="float32")
        srv = serve.LMServer(cfg, max_len=64, seed=5)
        prompt = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                   (1, 40))
        gen = srv.generate(prompt, 4)
        toks, want = prompt.copy(), []
        for _ in range(4):
            logits, _, _ = model.forward(
                srv.params, {"tokens": torch.as_tensor(toks, device="cuda")},
                cfg)
            want.append(int(logits[0, -1, :cfg.vocab_size].argmax()))
            toks = np.concatenate([toks, [[want[-1]]]], 1)
        if gen[0].tolist() != want:
            raise AssertionError(f"{arch}: greedy tokens {gen[0].tolist()} "
                                 f"!= teacher-forced {want}")

        batch = torch.as_tensor(prompt)
        card, _, _ = model.prefill(srv.params, {"tokens": batch.cuda()}, cfg,
                                   model.init_cache(cfg, 1, 64, "cuda"))
        cpu_params = model.LM(cfg, "cpu")
        cpu_params.load_state_dict(srv.params.state_dict())
        del srv
        cpu, _, _ = model.prefill(cpu_params, {"tokens": batch}, cfg,
                                  model.init_cache(cfg, 1, 64, "cpu"))
        err = float(((card.cpu() - cpu).abs()
                     / cpu.abs().clamp_min(1.0)).max())
        if not (torch.isfinite(card).all() and err <= 5e-3):
            raise AssertionError(f"{arch}: card vs CPU prefill logits: "
                                 f"{err} > 5e-3")
        log("serve_check", arch=arch, layers=cfg.n_layers,
            tokens=gen[0].tolist(), teacher_forced="equal",
            prefill_logits_err=f"{err:.3g}")
        out[arch] = dict(layers=cfg.n_layers, tokens=gen[0].tolist(),
                         prefill_logits_err=err)
    return out


def _top_device_ops(prof, k: int = 6):
    """The `k` kernels with the most device time in a profiler window:
    [(name, device ms, launches)]."""
    rows = [(e.key[:70], e.self_device_time_total / 1e3, e.count)
            for e in _kernel_events(prof)]
    return sorted(rows, key=lambda r: -r[1])[:k]


def phase_where():
    """Where the paths' time goes, outside the counted runs: one GS2
    solve alone on one thread, and the device's busy share (profiler)
    during a solve, a 10,000-task re-cost, and one zamba2 and one rwkv6
    request each (a 512-token prefill alone, then prefill + 16 new tokens)
    on a warm full-width server, with the operators that take the device
    time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.core import EvalRequest
    from repro_torch.launch import serve
    from repro_torch.sched import GPRuntimePredictor
    from repro_torch.uq import gs2_proxy, sampling

    theta = sampling.latin_hypercube(N_SIMS, seed=11)[0]
    gs2_proxy.solve(theta)                       # first use off the clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, iters = gs2_proxy.solve(theta)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    out = dict(solve_alone_s=solve_s, solve_iters=iters,
               us_per_iter=solve_s / iters * 1e6)

    pred = GPRuntimePredictor(min_fit=8, refit_every=10_000, fit_steps=50,
                              max_points=256)
    rng = np.random.default_rng(3)
    for t in sampling.latin_hypercube(256, seed=11):
        pred.observe(EvalRequest("gs2", [t.tolist()]),
                     float(rng.uniform(0.5, 5.0)))
    reqs = [EvalRequest("gs2", [t.tolist()])
            for t in sampling.latin_hypercube(10_000, seed=13)]
    pred.predict_many_with_sd(reqs)              # first use off the clock
    srv = serve.LMServer(configs.get(SERVE_ARCH), max_len=SERVE_MAX_LEN,
                         seed=0)
    prompt = rng.integers(0, srv.cfg.vocab_size, (1, 512))
    srv.generate(prompt, 2)                      # first use off the clock
    rwkv = serve.LMServer(configs.get(RWKV_ARCH), max_len=SERVE_MAX_LEN,
                          seed=0)
    rwkv_prompt = rng.integers(0, rwkv.cfg.vocab_size, (1, 512))
    rwkv.generate(rwkv_prompt, 2)                # first use off the clock
    for name, fn in (("solve", lambda: gs2_proxy.solve(theta)),
                     ("recost_10k", lambda: pred.predict_many_with_sd(reqs)),
                     ("serve_prefill_512", lambda: srv.generate(prompt, 1)),
                     ("serve_request_512+16",
                      lambda: srv.generate(prompt, SERVE_MAX_NEW)),
                     ("rwkv_prefill_512", lambda: rwkv.generate(rwkv_prompt,
                                                                1)),
                     ("rwkv_request_512+16",
                      lambda: rwkv.generate(rwkv_prompt, SERVE_MAX_NEW))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = _device_busy_ms(prof)
        if busy <= 0.0:                 # the profiler saw no device time
            busy = idle = None
        else:
            idle = 1 - busy / (wall * 1e3)
        top = (_top_device_ops(prof)
               if name not in ("solve", "recost_10k") else [])
        out[name] = dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                         device_idle_share=idle, top_device_ops=top)
        log("where", window=name, wall_ms=f"{wall * 1e3:.3f}",
            device_busy_ms=busy if busy is not None else "not measured",
            idle_share=idle if idle is not None else "not measured")
        for op, ms, calls in top:
            log("where.op", window=name, op=repr(op), device_ms=f"{ms:.3f}",
                calls=calls)
    log("where", window="solve_alone", iters=iters,
        us_per_iter=f"{out['us_per_iter']:.2f}")
    return out


# ---------------------------------------------------------------------------
def main() -> int:
    t_script = time.perf_counter()
    name, smi = phase_device()
    build_s = phase_build()
    rows = phase_kernels() + phase_lm_kernels()
    main_out, main_launches, post, backlog = phase_main()
    sim_out, sim_launches = phase_sim(post, backlog)
    serve_out, serve_launches = phase_serve()
    rwkv_out, rwkv_launches = phase_serve_rwkv()
    serve_check = phase_serve_check()
    where = phase_where()
    # each path's launches, counted from zero on that path
    by_path = {"main": main_launches, "sim": sim_launches,
               "serve": serve_launches, "serve_rwkv": rwkv_launches}
    launches = {}
    for per in by_path.values():
        for k, v in per.items():
            launches[k] = launches.get(k, 0) + v
    log("main.launches", **launches)

    replaces = {"gp_kernel_matrix": "src/repro/kernels/gp_kernel.py:23",
                # no Pallas kernel: XLA's autodiff of the reference matrix
                # inside the fit's value_and_grad
                "gp_kernel_matrix_grad": "src/repro/kernels/ref.py:361 "
                                         "(autodiff through "
                                         "src/repro/uq/gp.py:156)",
                "gp_predict": "src/repro/kernels/gp_kernel.py:79",
                "gp_predict_experts": "src/repro/kernels/gp_kernel.py:159",
                "flash_attention": "src/repro/kernels/flash_attention.py:30",
                "mamba2_ssd": "src/repro/kernels/mamba2_ssd.py:24",
                "rwkv6_wkv": "src/repro/kernels/rwkv6_scan.py:24"}
    kernels = []
    for r in rows:
        base = r["name"].split("[")[0]
        kernels.append(dict(
            name=r["name"], route="cuda", source=r["source"],
            replaces=replaces[base], launches=launches[base],
            launches_by_path={path: per[base] for path, per in by_path.items()
                              if base in per},
            max_abs_err=r["max_abs_err"], ms=r["ms"], call_ms=r["call_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            **{k: r[k] for k in ("kernel_launches_per_call", "scratch_bytes",
                                 "phase_ms", "launch_floor_ms", "note")
               if k in r}))
    script_s = time.perf_counter() - t_script
    log("total", seconds=f"{script_s:.1f}")
    record = dict(device=name, nvidia_smi=smi, build_s=build_s,
                  script_s=script_s,
                  kernels=kernels, launches=launches,
                  launches_by_path=by_path, main=main_out, sim=sim_out,
                  serve=serve_out, serve_rwkv=rwkv_out,
                  serve_check=serve_check, where=where,
                  event_timed=EVENT_TIMED)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    import torch
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
