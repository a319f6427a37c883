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
                profiler returns empty or short is taken again, and after
                five such the row is timed with CUDA events and named in
                the record's `event_timed`), its time per
                back-to-back call (CUDA events), the plain version's device
                time, the least time the card could take (bound) and, for
                attention, PyTorch's scaled_dot_product_attention on the
                same inputs as a yardstick (timed only; the port never
                calls it; the kernels it ran name its backend).  The
                attention forward at zamba2's, starcoder2's, qwen3-14b's
                (40 over 8 kv heads of 128), minicpm3-4b's MLA widths
                (40 heads, Dh 96, Dv 64), dbrx-132b's (48 over 8 kv heads
                of 128), deepseek-v3's MLA prefill (128 heads, Dh 192,
                Dv 128), and the train shapes of phi-3-vision-4.2b (B 2,
                32 MHA heads of 96) and musicgen-large (a microbatch of 1,
                32 MHA heads of 64).  The attention backward
                (flash_attention_bwd, three kernels per call, or four
                where the bf16 route splits the GQA group, asserted) at
                starcoder2's, phi-3-vision's and musicgen's train shapes
                in bf16, starcoder2's in f32, an MLA width and Sq < Skv,
                each bf16 row with its kernels' blocks per SM and shared
                memory, against
                float64 oracles (the plain blocked backward and autograd
                through the plain forward), with the backward of
                scaled_dot_product_attention as its yardstick.  First the launch floor: the device time of the
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
                three, asserted) and the scratch bytes (read from the
                caching allocator, held to the wrapper's layout).  The
                SSD backward (mamba2_ssd_bwd, four kernels per call,
                asserted) at zamba2's train shape (B 2, S 1024, 80 heads
                of 64, N 64) in bf16 and f32 and at S 777 with a state,
                against its plain version, with a bitwise repeat and each
                kernel's blocks per SM (the bf16 chunk gradients must
                hold two); and in a training step's call under a strong
                decay (a = -8, 8 heads, both routes), its ddt and da
                also against autograd of the sequential recurrence in
                float64.  The WKV backward (rwkv6_wkv_bwd, four kernels
                per call, asserted) at rwkv6-3b's train shape (B 2, S
                1024, 40 heads of 64) in bf16 and f32, at S 777 with a
                state, and at log w = -1.5 with a state and at log w =
                -1.5 and -69 from a zero state (as a training step
                calls it) against autograd of the sequential recurrence
                in float64, with a bitwise repeat and each kernel's
                blocks per SM (the bf16 chunk gradients must hold two).
                A bf16 gradient is held to the plain version run on the
                same values in f32, so that it carries one rounding.
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
  6. service  — the multi-tenant ServiceBroker through the port, with the
                recipes of benchmarks/broker_service.py: 48 GS2 solves
                from 3 tenants weighted 1:2:4 on 8 persistent workers (SJF
                inside each tenant, the GP runtime predictor warmed from
                main's conditioning set), run once uninterrupted, then
                again with a journal every 0.05 s, killed after a third
                are done and recovered: zero lost tasks, the same terminal
                set, and the recovered predictor's batched predict on
                10,000 backlog rows within 1e-5 of the checkpointed
                state's refit.  A partitioned GP predictor's state through
                JSON and back (backend kept, expert predict launched), the
                fair-share recipe through simulate_cluster (max relative
                error <= 10%), 20,000 submits under quotas with no
                workers.  The GP launch counters are zeroed before each
                path and read after it.
  7. serve    — LM serving at published widths and full depth (bf16,
                random weights from a seed) through the Executor, one
                arch after another: zamba2-2.7b (54 layers, d_model 2560),
                rwkv6-3b (32 layers, vocab 65536), qwen3-14b (40 layers,
                d_model 5120, GQA 40 over 8) and minicpm3-4b (62 layers,
                MLA): 8 requests on one persistent server (prompts of
                64-1023 tokens, 16 new tokens each), then 2 on fresh
                servers.  The LM kernels' launch counters are zeroed just
                before each; the arch's per-layer kernel (SSD, WKV,
                attention) must read at least one launch per layer per
                request just after, and zamba2's attention must have
                launched; the peak device memory stays under two servers'
                weights (fresh servers are built one at a time).  Then
                dbrx-132b and deepseek-v3-671b the same way at published
                widths with all their experts, 4 layers deep (26.58 and
                29.42 GiB; deepseek's first 3 dense, the 4th MoE): at
                least 4 attention launches per request, and a
                `serve.moe` line: the share of routed assignments dropped
                over the run's prefills (the bucket's pad tokens
                included), the largest expert load against its capacity,
                and, on one more server, a decode step's ms per token
                beside the time to read its weights.
  9. serve_check — outside the timed windows, in f32 at full width:
                zamba2 2 groups (12 layers) deep, rwkv6 4 layers,
                qwen3-14b 2, minicpm3-4b 4, yi-34b 2 (yi-34b runs on
                the card at this cut only), dbrx-132b 1 and
                deepseek-v3-671b 2 (one dense, one MoE with 32 of its 256
                experts).
                Greedy tokens equal the argmax of repeated full forwards
                (MoE archs at a capacity at which nothing drops, asserted),
                and prefill logits on the card match the port on the CPU
                with the same weights; for the MoE archs, every token's
                top-k experts and the dropped assignments are the same on
                both.  Then phi-3-vision-4.2b and musicgen-large 2 layers
                deep on the frontends' embeddings (the reference serves
                them through no server): a 300-position embedding prompt
                and 16 decode steps of one embedding each, from a seed;
                the cached decode's logits equal the teacher-forced
                forward's over the 316 positions, and the prefill's
                logits on the card match the port on the CPU and lie no
                further from a float64 forward than the CPU's own.
 10. train    — starcoder2-3b training through the port's train(): at its
                published widths and depth (30 layers, d_model 3072, bf16,
                remat, 3.18 B parameters, random weights from a seed), 6
                AdamW steps at B 2, S 1024 on synthetic data.  The
                attention counters are zeroed just before and must read
                exactly 2 x 30 x 6 forward and 30 x 6 backward launches
                just after; finite losses and grad norms, parameters
                moved; step ms (median of the last 4), tokens/s, peak
                device memory, and one more step profiled (device idle
                share, top kernels).  Then, 2 layers deep at full width:
                a 3-step run with checkpoints every 3 steps, its step-2
                checkpoint restored bit for bit, and a resume from it
                that follows an uninterrupted 6-step run; and one f32 step 2 layers deep on the
                card against the port on the CPU (the gradient against
                the same model in f64 on the CPU).  Then zamba2-2.7b
                the same way at its published widths and depth (54
                Mamba2 layers in 9 groups with the shared attention
                block, bf16, remat), its SSD's gradient through the
                backward kernel: the SSD and attention counters must read
                exactly 3 x 54 x 6 and 54 x 6, 2 x 9 x 6 and 9 x 6 (the
                remat is nested, as the reference's); the profiled step
                gives the SSD backward's ms; and one f32 step one group
                (6 layers) deep on the card against the CPU at
                ZAMBA_GRAD_LIMITS.  Then rwkv6-3b the same way at its
                published widths and depth (32 layers, d_model 2560, 40
                WKV heads of 64, bf16, remat), its WKV's gradient through
                the backward kernel: the WKV counters must read exactly
                2 x 32 x 6 forward and 32 x 6 backward launches; the
                profiled step gives the WKV backward's ms; and one f32
                step 2 layers deep on the card against the CPU at
                RWKV_GRAD_LIMITS.  Then phi-3-vision-4.2b (32 layers, 32
                MHA heads of 96) and musicgen-large (48 layers, 32 MHA
                heads of 64, accum_steps 2: two microbatches of 1 a step)
                the same way on the pipeline's embeddings: the attention
                counters must read 2 x 32 x 6 and 32 x 6, 2 x 48 x 6 x 2
                and 48 x 6 x 2; the profiled step gives the attention
                kernels' ms and launches; and one f32 step 2 layers deep on
                the card against the CPU at PHI3_GRAD_LIMITS and
                MUSICGEN_GRAD_LIMITS.  Then the MoE archs at published
                widths and accum_steps 1: dbrx-132b 1 layer deep with all
                16 experts (2 x 1 x 6 and 1 x 6 attention launches), and
                deepseek-v3-671b with its MTP loss, 4 layers deep (3
                dense), 32 of its 256 experts (2 x 4 x 6 + 6 and 4 x 6 +
                6: the MTP layer is not rematerialised); each with a
                `train.moe` line (drop share, the largest load against
                the capacity, every recompute routed as its forward) and
                one f32 step on the card against the CPU (dbrx 1 layer, 8
                experts; deepseek 1 layer, its MoE layer and the MTP
                block, 16 experts) at DBRX_GRAD_LIMITS and
                DEEPSEEK_GRAD_LIMITS, with 0 routing differences, a
                bitwise repeat and the host's seconds by stage.
 11. cost     — the dry run (repro_torch.launch.dryrun.run_cell on meta
                tensors: no allocation, no launch) of each of the seven
                train runs at the cut and accum_steps the train phase ran
                (B 2, S 1024): its kernel calls per step x 6 must equal
                the launches the run counted and _train_launches_want;
                the run's median step must take at least the roofline
                (the larger of the compute and memory terms: a roofline
                the card beats is a miscount), whose ratio to the step is
                printed beside the sum over ops of each op's own bound;
                the predicted peak must lie within 10% of the run's
                measured peak; the backward kernels' Python twins of the
                library's splits and scratch must agree with it at every
                shape the run gave them; and each arch's roofline becomes
                an hlo_runtime_prior that calibrate(priors=...) installs
                and runtime_fit(arch) reads back.  One `cost.<arch>` line
                each.
 12. where    — outside the counted runs: one GS2 solve alone, and the
                device's busy share (torch.profiler) during a solve, a
                10,000-task re-cost and one zamba2 and one rwkv6 request
                (a 512-token prefill, then prefill + 16 new tokens),
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
from typing import NamedTuple

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
# the dense family, served at published widths and full depth with the
# same mix (yi-34b, 64.1 GiB in bf16, is checked at a depth cut only)
DENSE_ARCHS = ("qwen3-14b", "minicpm3-4b")
# the MoE archs, served at published widths with all their experts, 4
# layers deep (dbrx 26.58 GiB, deepseek-v3 with its MTP block 29.42 GiB
# in bf16: one layer more would put two servers' weights past the card)
MOE_ARCHS = ("dbrx-132b", "deepseek-v3-671b")
MOE_SERVE_LAYERS = 4
# serve_check's archs, each with its cut (f32 at full width)
SERVE_CHECKS = (
    (SERVE_ARCH, dict(n_layers=12)),          # 2 groups of 6
    (RWKV_ARCH, dict(n_layers=4)), ("qwen3-14b", dict(n_layers=2)),
    ("minicpm3-4b", dict(n_layers=4)), ("yi-34b", dict(n_layers=2)),
    ("dbrx-132b", dict(n_layers=1)),
    ("deepseek-v3-671b", dict(n_layers=2, first_k_dense=1, n_experts=32)))
# serve_check's embedding-input archs: f32 at full width, 2 layers deep, a
# 300-position embedding prompt and 16 decode steps of one embedding each
EMBED_CHECKS = ("phi-3-vision-4.2b", "musicgen-large")
EMBED_CHECK_LAYERS = 2
EMBED_CHECK_PROMPT = 300
EMBED_CHECK_DECODE = 16


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
    many kernels, fewer kernel events than `expect * iters` (CUPTI drops
    kernel records now and then, at any shape); such a window is taken
    again, and after five of them the calls are timed with CUDA events
    (`call_ms`, an upper bound on the device time) and the row is named
    in EVENT_TIMED.  `by_kernel`, where given, receives each kernel's name
    and its (device ms, launches) per call from the profiler window; it
    stays empty when the calls were event-timed."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        events = _profile_window(fn, iters)
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


def _profile_window(fn, iters: int):
    """The device-side events of one profiler window of `iters` calls of
    `fn`, opened with one untimed call."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
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
    return _kernel_events(prof)


class DeviceEvents(NamedTuple):
    """One kernel (or copy) name's events in a profiler window, as
    `key_averages()` sums them: device us and launches."""
    key: str
    self_device_time_total: float
    count: int


def _kernel_events(prof):
    """The device-side events (kernels, copies) of a profiler window,
    summed by name, read once per window from the trace's own events.  A
    CPU operator's self device time repeats its kernels' time, so only
    the device's events are summed.  `key_averages()` gives the same sums
    but first builds the tree of every CPU operator in the window: 47 s
    for a warm 512 + 16 zamba2 request (416,000 events) on the card's
    host, where the window itself took 3 s."""
    from torch.autograd import DeviceType
    events = getattr(prof, "device_events", None)
    if events is None:
        sums = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                us, n = sums.get(e.name(), (0.0, 0))
                sums[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
        events = [DeviceEvents(k, us, n) for k, (us, n) in sums.items()]
        prof.device_events = events
    return events


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


def unrounded(*ts):
    """The tensors with bf16 ones in f32, the same values: a plain version
    run on them returns its f32 results unrounded, so a bf16 kernel output
    held to them carries one rounding, not two that may fall either side
    of a boundary (a full bf16 step apart)."""
    import torch
    return [t.float() if t is not None and t.dtype == torch.bfloat16 else t
            for t in ts]


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
        phase_ms, per_call = _phases(kernels, GP_GRAD_PHASES, run, label)
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
            scratch_bytes=measured_scratch(
                run, label, 4 * math.prod(gp_kernel.grad_scratch(n, n, d))),
            note="ms sums the device time of the call's two kernels (the "
                 "tiles' partial sums, their fixed-order reduction); the "
                 "launches per call and phase_ms are counted in a "
                 "profiler window"))

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
        phase_ms, per_call = _phases(kernels, GP_PREDICT_PHASES, run, label)
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
            phase_ms=phase_ms, scratch_bytes=measured_scratch(
                run, label, *(4 * math.prod(shape) for shape in
                              gp_kernel.predict_scratch(e, n, s, m).values())),
            note="ms sums the device time of the call's three kernels "
                 "(K0, triangular product, reduction); the launches per "
                 "call and phase_ms are counted in a profiler window"))
    for r in rows:
        r.update(source=src, library_ms=None)
        log("kernel", **{k: (f"{v:.6g}" if isinstance(v, float) else v)
                         for k, v in r.items()})
    return rows


def _bound_of(cost: dict):
    """`bound_ms` of a kernel's least work as its module's `cost` /
    `bwd_cost` states it (the dry run counts the same): its bytes, and its
    flops at the peak of their type (bf16 on the tensor cores, f32 on the
    CUDA cores)."""
    (kind, flops), = cost["flops"].items()
    return bound_ms(cost["bytes"], flops,
                    BF16_FLOP_PER_S if kind == "bfloat16" else F32_FLOP_PER_S)


def _twin_agrees(label: str, library, twin):
    """`library`, what a kernel library's C function answers (the
    backward's splits, its scratch), after checking that the Python twin
    the dry run uses on `meta` (`splits_rule`, `scratch_floats`) answers
    the same."""
    if library != twin:
        raise AssertionError(f"{label}: the library gives {library}, its "
                             f"Python twin {twin}")
    return library


# the three kernels of one gp_predict / gp_predict_experts, one mamba2_ssd
# and one rwkv6_wkv call, and the two of one gp_kernel_matrix_grad call, in
# launch order (their names as the profiler shows them contain these)
GP_PREDICT_PHASES = ("gp_predict_k0", "gp_predict_tri", "gp_predict_reduce")
GP_GRAD_PHASES = ("gp_kernel_matrix_grad_tiles", "gp_kernel_matrix_grad_reduce")
SSD_PHASES = ("ssd_chunk_state", "ssd_state_scan", "ssd_chunk_output")
# the four of one mamba2_ssd_bwd call: the state gradient's increments per
# chunk, the reverse scan over chunks, the chunk gradients, and the
# fixed-order reduction over heads and chunks
SSD_BWD_PHASES = ("ssd_bwd_state_inc", "ssd_bwd_state_scan",
                  "ssd_bwd_chunk_grad", "ssd_bwd_reduce")
WKV_PHASES = ("wkv_chunk_state", "wkv_state_scan", "wkv_chunk_output")
# the four of one rwkv6_wkv_bwd call, in launch order
WKV_BWD_PHASES = ("wkv_bwd_state_inc", "wkv_bwd_state_scan",
                  "wkv_bwd_chunk_grad", "wkv_bwd_reduce")


def _phases(by_kernel: dict, names, fn, label: str):
    """From one profiler window of calls: each named kernel's device ms
    per call, and the kernels launched per call.  Each of `names` must
    match exactly one kernel, launched once per call, and the window must
    hold no other kernel.  Where the timing window was event-timed (no
    kernel seen), the kernels are read from a window of three calls of
    `fn` of its own, taken up to five times until it holds every launch;
    the row fails where none does."""
    if not by_kernel:
        for attempt in range(5):
            events = _profile_window(fn, 3)
            if sum(e.count for e in events) >= 3 * len(names):
                by_kernel.update({e.key: (e.self_device_time_total / 1e3 / 3,
                                          e.count / 3) for e in events})
                break
            log("timing", label=label, count_window=attempt,
                note=f"the profiler saw {sum(e.count for e in events)} "
                     f"of the {3 * len(names)} kernel launches")
        else:
            raise AssertionError(f"{label}: no profiler window held the "
                                 f"{len(names)} kernels of each call")
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


def measured_scratch(fn, label: str, *layout: int) -> int:
    """The device memory one call of `fn` allocates beyond the tensors
    it returns (its scratch), read from the caching allocator's count of
    requested bytes (the allocated count includes whatever slack of a
    cached block the allocator hands over whole): the peak during the
    call less what was requested before and the returned tensors'
    storage.  `layout` is the byte size of each scratch tensor as the
    wrapper or its library states it; the call must have requested
    exactly those."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in (out if isinstance(out, tuple) else (out,))
                if t is not None}
    got = peak - before - sum(storages.values())
    want = sum(layout)
    if got != want:
        raise AssertionError(f"{label}: a call allocated {got} bytes of "
                             f"scratch, its layout states {want}")
    return got


# the backward's kernels in launch order: D = rowsum(dO O), dq, dk/dv and,
# where the bf16 route splits a kv head's group over G > 1 blocks, the
# fixed-order reduction of their partials
ATTN_BWD_PHASES = ("flash_attention_bwd_dot", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv")
ATTN_BWD_REDUCE = "flash_attention_bwd_reduce"


def _sdpa_bwd_ms(q, k, v, dout, label):
    """Device ms of the backward alone of PyTorch's
    scaled_dot_product_attention on the same operands (a yardstick, timed
    only; the port never calls it), with the causal diagonal at the
    bottom right as the kernel's.  None, with the reason logged, where
    SDPA refuses the shapes."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    h, hkv = q.shape[2], k.shape[2]
    sq, skv = q.shape[1], k.shape[1]
    try:
        if sq == skv:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=h != hkv)
        else:      # a lower-right causal bias; kv heads repeated beforehand
            qt, kt, vt = (t.repeat_interleave(h // t.shape[2], 2)
                          .transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=causal_lower_right(sq, skv))
        dot = dout.transpose(1, 2)
        return device_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 20,
            label=f"sdpa bwd {label}")
    except RuntimeError as e:
        log("kernel", label=f"sdpa bwd {label}", library="not measured",
            reason=repr(str(e)[:120]))
        return None


def _attention_bwd_rows(randn):
    """flash_attention_bwd against its plain version at the train paths'
    shapes (starcoder2-3b: B 2, S 1024, 24 query heads over 2 kv heads of
    128, in bf16 and f32; phi-3-vision-4.2b: B 2, 32 MHA heads of 96;
    musicgen-large: a microbatch of 1, 32 MHA heads of 64; dbrx-132b: B 2,
    48 query heads over 8 kv heads of 128; deepseek-v3-671b: B 2, 128 MLA
    heads of 192 -> 128, at S 1024 and at its MTP layer's S - 1 = 1023),
    an MLA width
    (Dh 192, Dv 128) and Sq < Skv.  The
    oracle is float64 on the card: the plain blocked backward
    (ref.attention_bwd) on the same q, k, v, output, log-sum-exp and
    output gradient, and autograd through ref.attention.  Tolerances per
    gradient, against max |grad|: f32 1e-4 max|g| + 1e-6 (the same f32
    products summed in another order, over a 1,024-key softmax); bf16
    2e-2 max|g| (the bf16 forward rounds P to bf16 before P V and its
    output to bf16, so D = rowsum(dO O) and the recomputed P carry those
    roundings; the bf16 backward rounds P and dS to bf16 before the
    products that take them, and each gradient to bf16 once;
    tests/test_torch_attention_bwd_bf16.py holds an emulation of that
    arithmetic to the same oracles on the CPU).  Each call is three
    kernels, or four where the bf16 route splits the GQA group
    (`fa.bwd_splits` > 1), asserted from a profiler window; its scratch
    is read from the allocator and held to the library's layout
    (`fa.bwd_scratch`).  The f32 row's bound is the f32 CUDA-core one (no
    TF32)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    for label, b, sq, skv, h, hkv, dh, dv, dtype in (
            ("starcoder2 bf16 S=1024", 2, 1024, 1024, 24, 2, 128, 128, bf16),
            ("starcoder2 f32 S=1024", 2, 1024, 1024, 24, 2, 128, 128, f32),
            ("MLA width bf16 S=1024", 1, 1024, 1024, 16, 16, 192, 128, bf16),
            ("starcoder2 bf16 Sq=512 Skv=1024", 2, 512, 1024, 24, 2, 128,
             128, bf16),
            ("phi-3-vision bf16 S=1024", 2, 1024, 1024, 32, 32, 96, 96,
             bf16),
            ("musicgen bf16 S=1024", 1, 1024, 1024, 32, 32, 64, 64, bf16),
            ("dbrx bf16 S=1024", 2, 1024, 1024, 48, 8, 128, 128, bf16),
            ("deepseek bf16 S=1024", 2, 1024, 1024, 128, 128, 192, 128,
             bf16),
            ("deepseek MTP bf16 S=1023", 2, 1023, 1023, 128, 128, 192, 128,
             bf16)):
        q = randn(b, sq, h, dh, dtype=dtype)
        k = randn(b, skv, hkv, dh, dtype=dtype)
        v = randn(b, skv, hkv, dv, dtype=dtype)
        dout = randn(b, sq, h, dv, dtype=dtype)
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        want = ref.attention_bwd(*(t.double() for t in (q, k, v, out, lse,
                                                         dout)))
        q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
        auto = torch.autograd.grad(ref.attention(q64, k64, v64),
                                   (q64, k64, v64), dout.double())
        rel = 2e-2 if dtype == bf16 else 1e-4
        err, rel_err = 0.0, 0.0
        for name, g_, w, a in zip(("dq", "dk", "dv"), got, want, auto):
            scale = float(w.abs().max())
            tol = rel * scale + (1e-6 if dtype == f32 else 0.0)
            e_w = max_err(g_.double(), w)
            e_a = max_err(g_.double(), a)
            if not (torch.isfinite(g_).all() and e_w <= tol and e_a <= tol):
                raise AssertionError(
                    f"flash_attention_bwd {label} {name}: {e_w} against the "
                    f"plain backward, {e_a} against autograd, > {tol}")
            err = max(err, e_w)
            rel_err = max(rel_err, e_w / scale)
        del want, auto, q64, k64, v64
        run = (lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout))
        if not all(torch.equal(x, y) for x, y in zip(got, run())):
            raise AssertionError(f"flash_attention_bwd {label}: two calls "
                                 f"differ")
        splits = fa.bwd_splits(q, k, v)
        _twin_agrees(f"flash_attention_bwd {label}",
                     (splits, fa.bwd_scratch(q, k, v)),
                     (fa.splits_rule(b, skv, h, hkv, dh, dv, dtype),
                      fa.scratch_floats(b, sq, skv, h, hkv, dh, dv, dtype)))
        phases = ATTN_BWD_PHASES + ((ATTN_BWD_REDUCE,) if splits > 1
                                    else ())
        kernels = {}
        ms = device_ms(run, 10, label=f"flash_attention_bwd {label}",
                       by_kernel=kernels, expect=len(phases))
        # each of `phases` launched once a call, and nothing else
        phase_ms, per_call = _phases(kernels, phases, run,
                                     f"flash_attention_bwd {label}")
        bnd, by = _bound_of(fa.bwd_cost(q, k, v))
        rows.append(dict(
            name=f"flash_attention_bwd[{label}]", source=fa.SOURCE,
            grad_tol=f"{rel:g} max|g|" + (" + 1e-6" if dtype == f32
                                           else ""),
            shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} dv{dv}",
            max_abs_err=err, max_rel_err=rel_err, ms=ms,
            call_ms=call_ms(run, 10),
            plain_ms=device_ms(lambda: ref.attention_bwd(q, k, v, out, lse,
                                                          dout), 3,
                               warmup=1, label=f"plain attention_bwd {label}"),
            bound_ms=bnd, bound_by=by,
            library_ms=_sdpa_bwd_ms(q, k, v, dout, label),
            kernel_launches_per_call=per_call, phase_ms=phase_ms,
            splits=splits, scratch_bytes=measured_scratch(
                run, f"flash_attention_bwd {label}",
                4 * fa.bwd_scratch(q, k, v)),
            deterministic=True,
            **({"blocks_per_sm": fa.bf16_occupancy(dh, dv)}
               if dtype == bf16 else {}),
            note=f"ms sums the device time of the call's {len(phases)} "
                 "kernels (D = rowsum(dO O), dq, dk/dv"
                 + (f", the reduction of G = {splits} partials"
                    if splits > 1 else "")
                 + "); bf16 on mma.sync, f32 on the CUDA cores; library_ms "
                   "is the backward of scaled_dot_product_attention alone"))
    return rows


def _ssd_bwd_rows(randn):
    """mamba2_ssd_bwd against its plain version (ref.mamba2_ssd_bwd) on the
    card, at the train path's shape (zamba2-2.7b: B 2, S 1024, 80 heads of
    64, N 64, no state and no final-state gradient, as a training step
    gives it) in bf16 (d in bf16, the model's D-skip) and f32, and at a
    ragged S with a state and the final state's gradient.  Tolerance per
    gradient, against its max|g|: 1e-4 (the same f32 sums in another
    order), plus 2^-8 for a gradient in bf16 (both round the f32 result
    once).  The bf16 route multiplies on the tensor cores with its f32
    operands split into two bf16 pieces each
    (tests/test_torch_ssd_bwd_tc.py holds an emulation of that arithmetic
    to the same tolerance on the CPU).  The plain version runs on the
    bf16 values in f32 (`unrounded`): its gradients are the f32 results
    the kernel rounds once.  Each call is four kernels,
    asserted from a profiler window, and two calls on the same inputs
    agree bit for bit (fixed-order sums, no atomics); the scratch is read
    from the allocator and held to the library's layout (`bwd_scratch`).
    Each row carries each kernel's blocks per SM (CUDA's occupancy
    calculator); the bf16 chunk gradients at N = 64 must hold two.  Two
    more rows, in bf16 and f32, take a training step's call under a strong
    decay (a = -8, no state, no final state's gradient) at 8 heads, where
    the kernel's ddt and da are also held to autograd of the sequential
    recurrence in float64 at 1e-4 max|g| (`rel_to_scan`): each in-chunk
    decay is summed from the log decays of its own steps."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ref
    bf16, f32 = torch.bfloat16, torch.float32
    names = ("dx", "ddt", "da", "db", "dc", "dd", "dstate")
    rows = []
    p, n = 64, 64
    for label, b, s, h, dtype, with_state, a_val in (
            ("zamba2 train bf16 B=2 S=1024", 2, 1024, 80, bf16, False, None),
            ("zamba2 train f32 B=2 S=1024", 2, 1024, 80, f32, False, None),
            ("zamba2 bf16 S=777 +state", 1, 777, 80, bf16, True, None),
            ("zamba2 width bf16 B=2 S=1024 H=8 a=-8", 2, 1024, 8, bf16,
             False, -8.0),
            ("zamba2 width f32 B=2 S=1024 H=8 a=-8", 2, 1024, 8, f32,
             False, -8.0)):
        x = randn(b, s, h, p, dtype=dtype)
        dt = F.softplus(randn(b, s, h))
        a = (-torch.ones(h, device="cuda") if a_val is None  # a_log init 0
             else torch.full((h,), a_val, device="cuda"))
        b_in, c_in = randn(b, s, n, dtype=dtype), randn(b, s, n, dtype=dtype)
        d = torch.ones(h, device="cuda", dtype=dtype)
        st = 0.1 * randn(b, h, p, n) if with_state else None
        dy = randn(b, s, h, p, dtype=dtype)
        dso = randn(b, h, p, n) if with_state else None
        args = (x, dt, a, b_in, c_in, d, st)
        _, _, states = ssd.mamba2_ssd(*args, return_states=True)
        run = (lambda: ssd.mamba2_ssd_bwd(*args, dy, dso, states=states))
        got = run()
        torch.cuda.synchronize()
        want = ref.mamba2_ssd_bwd(*unrounded(*args, dy), dso)
        err, rel_err, errs = 0.0, 0.0, {}
        for name, g_, w in zip(names, got, want):
            if w is None:
                continue
            scale = float(w.float().abs().max())
            rel = 1e-4 + (2 ** -8 if g_.dtype == bf16 else 0.0)
            e = max_err(g_.float(), w.float())
            errs[name] = e / scale if scale > 0 else e
            if not (torch.isfinite(g_).all() and e <= rel * scale):
                raise AssertionError(f"mamba2_ssd_bwd {label} {name}: {e} > "
                                     f"{rel} x {scale}")
            err, rel_err = max(err, e), max(rel_err, errs[name])
        rel_to_scan = None
        if a_val is not None:
            leaves = [t.double().requires_grad_() for t in args[:6]]
            y64, _ = ref.mamba2_ssd_scan(*leaves)
            scan = torch.autograd.grad(y64, leaves, dy.double())
            rel_to_scan = {}
            for name in ("ddt", "da"):
                i = names.index(name)
                e = max_err(got[i].double(), scan[i])
                rel_to_scan[name] = e / float(scan[i].abs().max())
                if not rel_to_scan[name] <= 1e-4:
                    raise AssertionError(
                        f"mamba2_ssd_bwd {label} {name}: "
                        f"{rel_to_scan[name]} max|g| from the f64 scan's")
            del leaves, y64, scan
        if not all(torch.equal(u, v) for u, v in zip(got, run())
                   if u is not None):
            raise AssertionError(f"mamba2_ssd_bwd {label}: two calls "
                                 f"differ")
        del want
        kernels = {}
        ms = device_ms(run, 10, label=f"mamba2_ssd_bwd {label}",
                       by_kernel=kernels, expect=len(SSD_BWD_PHASES))
        phase_ms, per_call = _phases(kernels, SSD_BWD_PHASES, run,
                                     f"mamba2_ssd_bwd {label}")
        bnd, by = _bound_of(ssd.bwd_cost(x, b_in, st, dso))
        blocks = ssd.bwd_blocks_per_sm(dtype, n)
        if dtype == bf16 and blocks["ssd_bwd_chunk_grad"] < 2:
            raise AssertionError(f"mamba2_ssd_bwd {label}: the chunk "
                                 f"gradients hold {blocks} blocks per SM")
        rows.append(dict(
            name=f"mamba2_ssd_bwd[{label}]", source=ssd.SOURCE,
            grad_tol="1e-4 max|g| (+ 2^-8 max|g| for a bf16 gradient)",
            shape=f"x{tuple(x.shape)} n{n}", max_abs_err=err,
            max_rel_err=rel_err, rel_err_by_grad=errs, ms=ms,
            call_ms=call_ms(run, 10),
            plain_ms=device_ms(lambda: ref.mamba2_ssd_bwd(*args, dy, dso), 3,
                               warmup=1, label=f"plain mamba2_ssd_bwd {label}"),
            bound_ms=bnd, bound_by=by, library_ms=None,
            kernel_launches_per_call=per_call, phase_ms=phase_ms,
            scratch_bytes=measured_scratch(
                run, f"mamba2_ssd_bwd {label}",
                4 * _twin_agrees(f"mamba2_ssd_bwd {label}",
                                 ssd.bwd_scratch(b, s, h, p, n),
                                 ssd.scratch_floats(b, s, h, p, n))),
            deterministic=True, blocks_per_sm=blocks,
            **({} if rel_to_scan is None else {"rel_to_scan": rel_to_scan}),
            note="ms sums the device time of the call's four kernels (the "
                 "state gradient's increments, the reverse scan, the chunk "
                 "gradients, the reduction); bf16 on mma.sync with split "
                 "f32 operands, f32 on the CUDA cores"))
    return rows


def _wkv_bwd_rows(randn):
    """rwkv6_wkv_bwd against its plain version (ref.rwkv6_wkv_bwd) on the
    card, at the train path's shape (rwkv6-3b: B 2, S 1024, 40 heads of 64,
    no state and no final-state gradient, as a training step gives it) in
    bf16 and f32 (w f32 as the model makes it), at a ragged S with a state
    and the final state's gradient, and under a strong decay (log w =
    -1.5 with a state; -1.5 and -69 from a zero state with no final
    state's gradient, as a training step calls it) against autograd of the
    sequential recurrence (ref.rwkv6_wkv_scan) in float64: every decay
    in the kernel is a product of max(w, 1e-30) over its own steps.
    Tolerance per gradient, against its
    max|g|: 1e-4 (the same f32 sums in another order), plus 2^-8 for a
    gradient in bf16 (the kernel rounds the f32 result once; the plain
    version runs on the bf16 values in f32, `unrounded`); dw is compared
    as w o dw, the log decay's gradient.  Each call is four kernels,
    asserted from a profiler window, and two calls on the same inputs agree
    bit for bit (a fixed-order reduction of du, no atomics); the scratch is
    read from the allocator and held to the library's layout
    (`bwd_scratch`).  Each row carries each kernel's blocks per SM (CUDA's
    occupancy calculator); the bf16 chunk gradients must hold two.  No single PyTorch call computes the function: library_ms is
    null."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wkv
    bf16, f32 = torch.bfloat16, torch.float32
    names = ("dr", "dk", "dv", "dw", "du", "dstate")
    rows = []
    h, kd = 40, 64
    for label, b, s, dtype, with_state, log_w in (
            ("rwkv6 train bf16 B=2 S=1024", 2, 1024, bf16, False, None),
            ("rwkv6 train f32 B=2 S=1024", 2, 1024, f32, False, None),
            ("rwkv6 bf16 S=777 +state", 1, 777, bf16, True, None),
            ("rwkv6 bf16 S=512 +state log w=-1.5 vs f64 scan", 1, 512, bf16,
             True, -1.5),
            ("rwkv6 bf16 S=512 log w=-1.5 vs f64 scan", 1, 512, bf16,
             False, -1.5),
            ("rwkv6 f32 S=512 log w=-69 vs f64 scan", 1, 512, f32, False,
             -69.0)):
        r, k, v = (randn(b, s, h, kd, dtype=dtype) for _ in range(3))
        if log_w is None:
            w = torch.exp(-torch.exp(0.5 * randn(b, s, h, kd) - 1.0))
        else:
            w = torch.full((b, s, h, kd), math.exp(log_w), device="cuda")
        u = randn(h, kd, dtype=dtype)
        st = 0.1 * randn(b, h, kd, kd) if with_state else None
        do = randn(b, s, h, kd, dtype=dtype)
        dso = randn(b, h, kd, kd) if with_state else None
        args = (r, k, v, w, u, st)
        _, _, states = wkv.rwkv6_wkv(*args, return_states=True)
        run = (lambda: wkv.rwkv6_wkv_bwd(*args, do, dso, states=states))
        got = run()
        torch.cuda.synchronize()
        if log_w is None:
            want = ref.rwkv6_wkv_bwd(*unrounded(*args, do), dso)
        else:
            leaves = [t.double().requires_grad_() for t in args
                      if t is not None]
            out64, fin64 = ref.rwkv6_wkv_scan(*leaves)
            if dso is None:             # a loss of the output alone
                want = list(torch.autograd.grad(out64, leaves, do.double()))
            else:
                want = list(torch.autograd.grad((out64, fin64), leaves,
                                                (do.double(), dso.double())))
            if st is None:
                want.append(None)
            del leaves, out64, fin64
        err, rel_err, errs = 0.0, 0.0, {}
        for name, g_, x in zip(names, got, want):
            if x is None:
                continue
            g_, x = g_.double(), x.double()
            if name == "dw":
                g_, x = g_ * w.double(), x * w.double()
            scale = float(x.abs().max())
            rel = 1e-4 + (2 ** -8 if dtype == bf16
                          and name in ("dr", "dk", "dv", "du") else 0.0)
            e = max_err(g_, x)
            errs[name] = e / scale if scale > 0 else e
            if not (torch.isfinite(g_).all() and e <= rel * scale):
                raise AssertionError(f"rwkv6_wkv_bwd {label} {name}: {e} > "
                                     f"{rel} x {scale}")
            err, rel_err = max(err, e), max(rel_err, errs[name])
        del want
        if not all(torch.equal(a_, b_) for a_, b_ in zip(got, run())
                   if a_ is not None):
            raise AssertionError(f"rwkv6_wkv_bwd {label}: two calls differ")
        kernels = {}
        ms = device_ms(run, 10, label=f"rwkv6_wkv_bwd {label}",
                       by_kernel=kernels, expect=len(WKV_BWD_PHASES))
        phase_ms, per_call = _phases(kernels, WKV_BWD_PHASES, run,
                                     f"rwkv6_wkv_bwd {label}")
        bnd, by = _bound_of(wkv.bwd_cost(r, v, st, dso))
        blocks = wkv.bwd_blocks_per_sm(dtype, kd)
        if dtype == bf16 and blocks["wkv_bwd_chunk_grad"] < 2:
            raise AssertionError(f"rwkv6_wkv_bwd {label}: the chunk "
                                 f"gradients hold {blocks} blocks per SM")
        rows.append(dict(
            name=f"rwkv6_wkv_bwd[{label}]", source=wkv.SOURCE,
            grad_tol="1e-4 max|g| (+ 2^-8 max|g| for a bf16 gradient); dw "
                     "as w o dw",
            shape=f"r{tuple(r.shape)} v{tuple(v.shape)}", max_abs_err=err,
            max_rel_err=rel_err, rel_err_by_grad=errs, ms=ms,
            call_ms=call_ms(run, 10),
            plain_ms=device_ms(lambda: ref.rwkv6_wkv_bwd(*args, do, dso), 2,
                               warmup=1,
                               label=f"plain rwkv6_wkv_bwd {label}"),
            bound_ms=bnd, bound_by=by, library_ms=None,
            kernel_launches_per_call=per_call, phase_ms=phase_ms,
            scratch_bytes=measured_scratch(
                run, f"rwkv6_wkv_bwd {label}",
                4 * _twin_agrees(f"rwkv6_wkv_bwd {label}",
                                 wkv.bwd_scratch(b, s, h, kd, kd),
                                 wkv.scratch_floats(b, s, h, kd, kd))),
            deterministic=True, blocks_per_sm=blocks,
            note="ms sums the device time of the call's four kernels (the "
                 "state gradient's increments, the reverse scan, the chunk "
                 "gradients, the reduction of du); every decay a product "
                 "of max(w, 1e-30), no exponential; bf16: the state terms' "
                 "products and do.v on mma.sync (S, G and k o edec split "
                 "into two bf16 pieces), the rest f32 on the CUDA cores; "
                 "f32 on the CUDA cores"))
    return rows


def phase_lm_kernels():
    """flash_attention, mamba2_ssd and rwkv6_wkv against their plain
    versions at the serve paths' shapes (zamba2: 32 heads of 80, 80 SSD
    heads of 64 with a 64-wide state; starcoder2: a GQA group of 12 with
    heads of 128; rwkv6-3b: 40 WKV heads of 64; the dense and MoE archs'
    prefills) and the attention forward at phi-3-vision's, musicgen's,
    dbrx-132b's and deepseek-v3-671b's train shapes (MHA at 96 and 64, GQA
    48 over 8 at 128, MLA 128 heads at 192 -> 128 at S 1024 and at the
    MTP layer's 1023; deepseek's also against the plain version in
    float64),
    then the backwards at the train
    paths' shapes (`_ssd_bwd_rows`, `_wkv_bwd_rows`,
    `_attention_bwd_rows`)."""
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
    for label, b, sq, h, hkv, dh, dv, dtype in (
            ("zamba2 bf16 S=1024", 1, 1024, 32, 32, 80, 80, bf16),
            ("zamba2 bf16 S=777", 1, 777, 32, 32, 80, 80, bf16),
            ("starcoder2 bf16 S=1024", 1, 1024, 24, 2, 128, 128, bf16),
            ("zamba2 f32 S=1024", 1, 1024, 32, 32, 80, 80, f32),
            ("qwen3 bf16 S=1024", 1, 1024, 40, 8, 128, 128, bf16),
            ("minicpm3 bf16 S=1024", 1, 1024, 40, 40, 96, 64, bf16),
            ("minicpm3 f32 S=1024", 1, 1024, 40, 40, 96, 64, f32),
            ("dbrx bf16 S=1024", 1, 1024, 48, 8, 128, 128, bf16),
            ("deepseek bf16 S=1024", 1, 1024, 128, 128, 192, 128, bf16),
            ("phi-3-vision train bf16 B=2 S=1024", 2, 1024, 32, 32, 96, 96,
             bf16),
            ("musicgen train bf16 S=1024", 1, 1024, 32, 32, 64, 64, bf16),
            ("dbrx train bf16 B=2 S=1024", 2, 1024, 48, 8, 128, 128, bf16),
            # deepseek-v3's training: its 4 layers, and its MTP layer at
            # S - 1
            ("deepseek train bf16 B=2 S=1024", 2, 1024, 128, 128, 192, 128,
             bf16),
            ("deepseek MTP train bf16 B=2 S=1023", 2, 1023, 128, 128, 192,
             128, bf16)):
        q = randn(b, sq, h, dh, dtype=dtype)
        k = randn(b, sq, hkv, dh, dtype=dtype)
        v = randn(b, sq, hkv, dv, dtype=dtype)
        tol = 2e-2 if dtype == bf16 else 2e-5
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = max_err(got.float(), ref.attention(q, k, v).float())
        # deepseek-v3's train rows are also held to the plain version in
        # float64, as the backward's rows are
        err64 = (max_err(got.double(), ref.attention(
            q.double(), k.double(), v.double()))
            if label.startswith("deepseek") and "train" in label else None)
        if not (err <= tol and (err64 is None or err64 <= tol)):
            raise AssertionError(f"flash_attention {label}: {err} (float64: "
                                 f"{err64}) > {tol}")
        run = (lambda: fa.flash_attention(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        # every call launches at least one kernel (the port's exactly
        # one): a window that saw fewer is taken again (`device_ms`)
        sdpa = {}
        library = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=h != hkv), 200,
            label=f"sdpa {label}", by_kernel=sdpa, expect=1)
        bnd, by = _bound_of(fa.cost(q, k, v))
        row = dict(
            name=f"flash_attention[{label}]", source=fa.SOURCE, tol=tol,
            shape=f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}",
            max_abs_err=err,
            ms=device_ms(run, 20, label=f"flash_attention {label}",
                         expect=1),
            call_ms=call_ms(run, 20),
            plain_ms=device_ms(lambda: ref.attention(q, k, v), 10,
                               label=f"plain attention {label}", expect=1),
            bound_ms=bnd, bound_by=by, library_ms=library,
            # which SDPA backend ran: its kernels, by device time
            library_kernels=[name[:90] for name, _ in sorted(
                sdpa.items(), key=lambda kv: -kv[1][0])[:3]])
        if err64 is not None:
            row["max_abs_err_f64"] = err64
        if dtype == bf16:
            row["blocks_per_sm"] = fa.bf16_occupancy(dh, dv)
        rows.append(row)

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
        b, by = _bound_of(ssd.cost(x, b_in, st))
        kernels = {}
        ms = device_ms(run, iters, label=f"mamba2_ssd {label}",
                       by_kernel=kernels, expect=len(SSD_PHASES))
        phase_ms, per_call = _phases(kernels, SSD_PHASES, run,
                                     f"mamba2_ssd {label}")
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
            scratch_bytes=measured_scratch(
                run, f"mamba2_ssd {label}",
                *(t.nbytes for t in ssd.scratch(*x.shape, n, dev))),
            note="ms sums the device time of the call's three kernels "
                 "(chunk states, state scan, output); the launches per "
                 "call and phase_ms are counted in a profiler window"))

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
        b, by = _bound_of(wkv.cost(r, v, st))
        kernels = {}
        ms = device_ms(run, iters, label=f"rwkv6_wkv {label}",
                       by_kernel=kernels, expect=len(WKV_PHASES))
        phase_ms, per_call = _phases(kernels, WKV_PHASES, run,
                                     f"rwkv6_wkv {label}")
        rows.append(dict(
            name=f"rwkv6_wkv[{label}]", source=wkv.SOURCE, tol=tol,
            shape=f"r{tuple(r.shape)} v{tuple(v.shape)}", max_abs_err=err,
            ms=ms, call_ms=call_ms(run, iters),
            plain_ms=device_ms(lambda: ref.rwkv6_wkv(*args), 2, warmup=1,
                               label=f"plain rwkv6_wkv {label}"),
            bound_ms=b, bound_by=by, library_ms=None,
            kernel_launches_per_call=per_call, phase_ms=phase_ms,
            scratch_bytes=measured_scratch(
                run, f"rwkv6_wkv {label}",
                *(t.nbytes for t in wkv.scratch(*r.shape, v.shape[3], dev))),
            note="ms sums the device time of the call's three kernels "
                 "(chunk states, state scan, output); the launches per "
                 "call and phase_ms are counted in a profiler window"))
    rows += _ssd_bwd_rows(randn)
    rows += _wkv_bwd_rows(randn)
    rows += _attention_bwd_rows(randn)
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
    return out, launches, post, backlog, predictor.state_dict()


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


# ---------------------------------------------------------------------------
# the multi-tenant broker service through the port (phase `service`); the
# recipes are benchmarks/broker_service.py's, copied, with GS2 tasks in
# place of its sleeping toy model for the kill and recover
SERVICE_WEIGHTS = {"a": 1.0, "b": 2.0, "c": 4.0}   # its WEIGHTS
SERVICE_TASKS = 48
SERVICE_WORKERS = 8
SERVICE_JOURNAL_S = 0.05
SERVICE_PREDICT_ROWS = 10_000
# the recovered predictor against the checkpointed one: both refit from
# the same journal state on one card, where the fit's kernels sum in a
# fixed order, so they agree to f32 rounding or better
SERVICE_PREDICT_TOL = 1e-5
FAIR_SHARE_BURST = 112       # its full-size bench_fair_share
FAIR_SHARE_MAX_ERR = 0.10    # its gate
INGEST_TASKS = 20_000        # its full-size bench_ingestion


def _service_reqs(thetas):
    from repro_torch.core import EvalRequest
    tenants = sorted(SERVICE_WEIGHTS)
    return [EvalRequest("gs2", [t.tolist()], time_request=1.0,
                        time_limit=900.0, tenant=tenants[i % 3],
                        task_id=f"svc-{i}") for i, t in enumerate(thetas)]


def _service_broker(gp_state, **kw):
    """A ServiceBroker over persistent GS2 workers at main's resolution:
    tenants 1:2:4, SJF inside each tenant's queue (so queue re-costs go
    through the GP's batched predict), and the GP runtime predictor
    ("gp", exact backend) warmed from main's conditioning set."""
    from repro_torch.sched import GPRuntimePredictor
    from repro_torch.service import ServiceBroker
    from repro_torch.uq import gs2_proxy
    pred = GPRuntimePredictor()
    pred.load_state(gp_state)
    return ServiceBroker({"gs2": _gs2_factory(gs2_proxy.DEFAULT_RESOLUTION)},
                         weights=SERVICE_WEIGHTS, inner_policy="sjf",
                         predictor=pred, n_workers=SERVICE_WORKERS,
                         persistent_servers=True, **kw)


def _fair_share(burst):
    """bench_fair_share: tenants 1:2:4 on a saturating burst, CPU-second
    shares at the 3/4-drain horizon of simulate_cluster."""
    from repro_torch.cluster import bursty_trace, simulate_cluster, \
        with_tenants
    from repro_torch.core import backends
    from repro_torch.sched import FairSharePolicy
    trace = with_tenants(
        bursty_trace(n_bursts=1, burst_size=burst, burst_span_s=1.0,
                     runtime_s=4.0, jitter=0.0, seed=3), SERVICE_WEIGHTS)
    tenant_of = {f"trace-{i}": tt.tenant for i, tt in enumerate(trace)}
    res = simulate_cluster(
        backends.get("hq"), trace,
        policy=lambda: FairSharePolicy(weights=SERVICE_WEIGHTS,
                                       quantum_s=8.0),
        n_workers=2, seed=3)
    done = sorted((r for r in res.records if r.status == "ok"),
                  key=lambda r: r.end_t)
    part = done[:(3 * len(done)) // 4]
    cpu = {t: 0.0 for t in SERVICE_WEIGHTS}
    for r in part:
        cpu[tenant_of[r.task_id]] += r.cpu_time
    total = sum(cpu.values())
    wsum = sum(SERVICE_WEIGHTS.values())
    shares = {t: cpu[t] / total for t in SERVICE_WEIGHTS}
    err = max(abs(shares[t] - w / wsum) / (w / wsum)
              for t, w in SERVICE_WEIGHTS.items())
    return dict(tasks=len(trace), horizon_tasks=len(part), shares=shares,
                max_rel_error=err)


def _ingestion(n):
    """bench_ingestion: n submits through admission control (quotas,
    tenant-labelled counters) into the broker with no workers."""
    from repro_torch.core import EvalRequest, LambdaModel
    from repro_torch.service import ServiceBroker

    def toy():
        return LambdaModel("toy", lambda p, c: [[float(p[0][0])]], 1, 1)
    svc = ServiceBroker({"toy": toy}, n_workers=0, weights=SERVICE_WEIGHTS,
                        quotas={t: n * 2 for t in SERVICE_WEIGHTS})
    tenants = sorted(SERVICE_WEIGHTS)
    reqs = [EvalRequest("toy", [[float(i)]], time_request=1.0,
                        time_limit=60.0, tenant=tenants[i % 3])
            for i in range(n)]
    t0 = time.perf_counter()
    for r in reqs:
        svc.submit(r)
    dt = time.perf_counter() - t0
    svc.kill()
    return dict(tasks=n, seconds=dt, us_per_submit=dt / n * 1e6)


def phase_service(gp_state, backlog):
    """The port's ServiceBroker on the card: a GS2 workload run through
    uninterrupted, then run again, killed after a third of its tasks and
    recovered from its journal (zero lost tasks, the same terminal set,
    the recovered GP predicting as the checkpointed one does); a
    partitioned GP predictor's state round trip; the fair-share recipe;
    ingestion under quotas.  Each path's GP launches count from zero."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import Journal
    from repro_torch.kernels import gp_kernel
    from repro_torch.sched import GPRuntimePredictor
    from repro_torch.service import ServiceBroker
    from repro_torch.uq import gs2_proxy, sampling

    out, launches = {}, {}
    t_phase = time.perf_counter()
    thetas = sampling.latin_hypercube(SERVICE_TASKS, seed=15)
    jdir = ROOT / "build" / "service_journal"
    shutil.rmtree(jdir, ignore_errors=True)

    # 1. kill and recover with the GP runtime predictor
    torch.cuda.synchronize()
    gp_kernel.reset_launches()
    t0 = time.perf_counter()
    with _service_broker(gp_state) as svc:
        ids = [svc.submit(r) for r in _service_reqs(thetas)]
        base = [svc.result(t, timeout=300.0) for t in ids]
    base_s = time.perf_counter() - t0
    base_terminal = {(r.task_id, r.status) for r in base}
    if any(r.status != "ok" for r in base):
        raise AssertionError("an uninterrupted service task did not end ok")

    t0 = time.perf_counter()
    svc = _service_broker(gp_state, journal_dir=str(jdir),
                          journal_every_s=SERVICE_JOURNAL_S)
    ids = [svc.submit(r) for r in _service_reqs(thetas)]
    deadline = time.monotonic() + 300.0
    while sum(r.status == "ok" for r in svc.records()) < SERVICE_TASKS // 3:
        if time.monotonic() > deadline:
            raise AssertionError("the service never reached a third done")
        time.sleep(0.005)
    svc.checkpoint()
    svc.kill()
    svc._writer.join(timeout=5.0)      # its last publish is on disk
    done_before = sum(r.status == "ok" for r in svc.records())
    t_kill = time.perf_counter() - t0
    journal = Journal(jdir).latest()[1]["snapshot"]
    held = set(journal["completed"]) | {p["task_id"]
                                        for p in journal["pending"]}
    if set(ids) - held:
        raise AssertionError(f"the journal lost tasks: "
                             f"{sorted(set(ids) - held)}")
    checkpointed = journal["predictor"]
    # no workers until the recovered predictor is taken: the journal's
    # state, refitted, before any completion conditions it
    t1 = time.perf_counter()
    svc2 = ServiceBroker.recover(
        {"gs2": _gs2_factory(gs2_proxy.DEFAULT_RESOLUTION)},
        journal_dir=str(jdir), predictor="gp", inner_policy="sjf",
        n_workers=0, persistent_servers=True,
        journal_every_s=SERVICE_JOURNAL_S)
    recover_s = time.perf_counter() - t1
    recovered = svc2._ex.predictor._engine
    svc2._ex.scale_to(SERVICE_WORKERS)
    res = [svc2.result(t, timeout=300.0) for t in ids]
    svc2.shutdown()
    torch.cuda.synchronize()
    killed_s = time.perf_counter() - t0
    launches["kill_recover"] = dict(gp_kernel.launches)
    terminal = {(r.task_id, r.status) for r in res}
    lost = SERVICE_TASKS - len({r.task_id for r in res
                                if r.status in ("ok", "failed")})
    if lost or terminal != base_terminal:
        raise AssertionError(f"kill/recover lost {lost} tasks; terminal "
                             f"sets equal: {terminal == base_terminal}")
    missing = [k for k in ("gp_kernel_matrix", "gp_kernel_matrix_grad",
                           "gp_predict") if launches["kill_recover"][k] < 1]
    if missing:
        raise AssertionError(f"never launched on kill/recover: {missing}")
    if recovered is None or checkpointed is None:
        raise AssertionError("the journal carried no fitted GP predictor")

    # outside the counted run: the checkpointed predictor, refitted from
    # the state the kill left, against the recovered one
    ref = GPRuntimePredictor()
    ref.load_state(checkpointed)
    rows = backlog[:SERVICE_PREDICT_ROWS]
    rm, rv = recovered.predict_batch(rows)
    cm, cv = ref._engine.predict_batch(rows)
    err_m = float((rm - cm).abs().max())
    err_v = float((rv - cv).abs().max())
    if not (err_m <= SERVICE_PREDICT_TOL and err_v <= SERVICE_PREDICT_TOL
            and torch.isfinite(rm).all() and torch.isfinite(rv).all()):
        raise AssertionError(f"recovered vs checkpointed predictor: mean "
                             f"{err_m}, var {err_v} > {SERVICE_PREDICT_TOL}")
    out["kill_recover"] = dict(
        tasks=SERVICE_TASKS, workers=SERVICE_WORKERS,
        done_before_kill=done_before, lost_tasks=lost,
        uninterrupted_s=base_s, killed_at_s=t_kill, recover_s=recover_s,
        kill_recover_s=killed_s, makespan_penalty=killed_s / base_s - 1.0,
        predictor_n=len(checkpointed["xs"]), predict_rows=len(rows),
        predict_mean_err=err_m, predict_var_err=err_v,
        launches=launches["kill_recover"])
    log("service.kill_recover", tasks=SERVICE_TASKS, workers=SERVICE_WORKERS,
        done_before_kill=done_before, lost_tasks=lost,
        uninterrupted_s=f"{base_s:.3f}", killed_at_s=f"{t_kill:.3f}",
        recover_s=f"{recover_s:.3f}", kill_recover_s=f"{killed_s:.3f}",
        makespan_penalty=f"{killed_s / base_s - 1.0:.4f}",
        predictor_n=len(checkpointed["xs"]),
        predict_mean_err=f"{err_m:.3g}", predict_var_err=f"{err_v:.3g}",
        **{f"launches_{k}": v for k, v in launches["kill_recover"].items()})

    # 2. a partitioned GP predictor's state through JSON and back
    gp_kernel.reset_launches()
    t0 = time.perf_counter()
    part = GPRuntimePredictor()
    part.load_state(dict(gp_state, backend="partitioned"))
    state = json.loads(json.dumps(part.state_dict()))
    back = GPRuntimePredictor()
    back.load_state(state)
    costs = back.predict_many(_service_reqs(backlog[:1024]))
    torch.cuda.synchronize()
    part_s = time.perf_counter() - t0
    launches["partitioned"] = dict(gp_kernel.launches)
    if not (state["backend"] == back.backend == "partitioned"
            and back._engine.backend == "partitioned"):
        raise AssertionError(f"the backend did not survive: {back.backend}")
    if launches["partitioned"]["gp_predict_experts"] < 1 or \
            not (np.isfinite(costs).all() and min(costs) > 0):
        raise AssertionError("partitioned round trip: no expert launch or "
                             "malformed costs")
    out["partitioned"] = dict(experts=len(back._engine.experts),
                              seconds=part_s, launches=launches["partitioned"])
    log("service.partitioned", backend=back.backend,
        experts=len(back._engine.experts), seconds=f"{part_s:.3f}",
        **{f"launches_{k}": v for k, v in launches["partitioned"].items()})

    # 3. fair share (simulated) and 4. ingestion: host paths, no GP
    fair = _fair_share(FAIR_SHARE_BURST)
    if fair["max_rel_error"] > FAIR_SHARE_MAX_ERR:
        raise AssertionError(f"fair-share error {fair['max_rel_error']}")
    out["fair_share"] = fair
    log("service.fair_share", tasks=fair["tasks"],
        horizon_tasks=fair["horizon_tasks"],
        max_rel_error=repr(fair["max_rel_error"]),
        **{f"share_{t}": repr(v) for t, v in fair["shares"].items()})
    ingest = _ingestion(INGEST_TASKS)
    out["ingestion"] = ingest
    log("service.ingestion", tasks=INGEST_TASKS,
        seconds=f"{ingest['seconds']:.3f}",
        us_per_submit=f"{ingest['us_per_submit']:.2f}")

    total = {}
    for per in launches.values():
        for k, v in per.items():
            total[k] = total.get(k, 0) + v
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log("service.total", seconds=f"{out['seconds']:.3f}",
        **{f"launches_{k}": v for k, v in total.items()})
    return out, total


def phase_serve(arch, kernels):
    """`arch` at its published widths and depth through the port's
    Executor: a persistent server, then fresh servers.  Every LM kernel's
    launch counter is zeroed just before and read just after.  Every
    prefill runs `kernels[0]` once per layer, so its counter must reach
    n_layers x requests (warm-ups add more); each other kernel named must
    have launched.  The fresh servers are built one at a time: the peak
    must stay under two servers' weights (a lingering server would put a
    third beside them).  For an MoE arch every MoE layer's routing is
    observed over the run (`moe.observe`) and summed after it
    (`_moe_serve_stats`)."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.launch import serve
    from repro_torch.models import model, moe

    counters = {"flash_attention": fa, "mamba2_ssd": ssd, "rwkv6_wkv": wkv}
    cfg = configs.get(arch)
    routes = []

    def on_route(idx, keep, cap):
        # a prefill's routing (a decode step routes one token): dropped
        # assignments, all of them, the largest expert load, the capacity,
        # the tokens; kept on the device until the run ends
        if idx.shape[0] > 1:
            load = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
            routes.append(((~keep).sum(), keep.numel(), load.max(), cap,
                           idx.shape[0]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in counters.values():
        mod.reset_launches()
    out = {}
    t_serve = time.perf_counter()
    with contextlib.ExitStack() as watch:
        if cfg.n_experts:
            watch.enter_context(moe.observe(on_route))
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
    out["weights_gib"] = model.count_params(cfg) * 2 / 2 ** 30
    need = cfg.n_layers * (SERVE_REQUESTS + SERVE_FRESH)
    log("serve.total", arch=arch, seconds=f"{out['serve_s']:.3f}",
        peak_device_gib=f"{out['peak_device_gib']:.2f}",
        weights_gib=f"{out['weights_gib']:.2f}", need=need, **launches)
    if launches[kernels[0]] < need:
        raise AssertionError(f"{kernels[0]} launched {launches[kernels[0]]} "
                             f"times on the {arch} serve path, fewer than "
                             f"{need}")
    for k in kernels[1:]:
        if launches[k] < 1:
            raise AssertionError(f"{k} never launched on the {arch} serve "
                                 f"path")
    if out["peak_device_gib"] >= 2 * out["weights_gib"]:
        raise AssertionError(f"{arch}: peak {out['peak_device_gib']:.2f} "
                             f"GiB reaches two servers' weights "
                             f"({2 * out['weights_gib']:.2f} GiB)")
    if cfg.n_experts:
        out["moe"] = _moe_serve_stats(arch, cfg, routes)
    return out, {k: launches[k] for k in kernels}


def _moe_serve_stats(arch, cfg, routes):
    """The served run's routing over its prefills (the bucket's pad tokens
    included): over all of them, and over the requests' alone (a bucket of
    at least SERVE_MIN_PROMPT tokens; a server's warm-up prefills 16
    tokens of one id, which all route alike).  Then, outside the counted
    run, a decode step's ms per token
    on one more server (a 512-token prompt, SERVE_MAX_LEN / 4, then 16 new
    tokens against 1,
    the median of 3 each): with the reference's dense capacity buffers
    every decode step reads every expert's weights."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model
    def share(rs):
        return sum(int(r[0]) for r in rs) / sum(r[1] for r in rs)

    requests = [r for r in routes if r[4] >= SERVE_MIN_PROMPT]
    worst = max(requests, key=lambda r: int(r[2]) / r[3])
    srv = serve.LMServer(cfg, max_len=SERVE_MAX_LEN, seed=0)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (1, SERVE_MAX_LEN // 4))
    srv.generate(prompt, 2)
    walls = {}
    for n in (1, 1 + SERVE_MAX_NEW):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.generate(prompt, n)
            ts.append(time.perf_counter() - t0)
        walls[n] = statistics.median(ts)
    del srv
    decode_ms = ((walls[1 + SERVE_MAX_NEW] - walls[1]) * 1e3
                 / SERVE_MAX_NEW)
    n_moe = cfg.n_layers - cfg.first_k_dense
    expert_bytes = n_moe * 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff * 2
    # the weights a decode step reads: all but the embedding (one row) and
    # the MTP block (training only)
    weight_bytes = 2 * sum(p.numel() for n, p in model.LM(
        cfg, "meta").named_parameters()
        if not n.startswith(("embedding", "mtp.")))
    out = dict(prefill_moe_calls=len(routes),
               assignments=sum(r[1] for r in routes),
               dropped=sum(int(r[0]) for r in routes),
               drop_share=share(routes),
               request_moe_calls=len(requests),
               request_drop_share=share(requests),
               max_load=int(worst[2]), capacity_at_max=worst[3],
               max_load_over_capacity=int(worst[2]) / worst[3],
               decode_ms_per_token=decode_ms,
               decode_expert_gb_per_token=expert_bytes / 1e9,
               decode_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3)
    log("serve.moe", arch=arch, **{k: (f"{v:.6g}" if isinstance(v, float)
                                      else v) for k, v in out.items()})
    return out


def phase_serve_check():
    """Outside the timed windows, in f32 at full width: zamba2-2.7b 2
    groups (12 layers) deep, rwkv6-3b 4 layers, qwen3-14b 2, minicpm3-4b
    4, yi-34b 2 (yi-34b serves on the card at this cut only), dbrx-132b 1
    (all 16 experts, 16.73 GiB) and deepseek-v3-671b 2 (its first dense,
    the second MoE with 32 of its 256 experts, top-8 kept, 17.75 GiB; 256
    experts in f32 are 42 GiB a layer).  (a) LMServer.generate's greedy
    tokens equal the argmax of repeated full forwards
    (tests/test_serve.py's check); an MoE arch runs this at the capacity
    factor E / k, at which no assignment can drop (asserted on both
    sides): with drops a bucketed prefill, whose capacity counts the pad
    tokens, may drop other assignments than a forward over the prompt, as
    the reference's does.  (b) prefill logits on the card match the port
    on the CPU with the same weights, within 5e-3 relative to max(|x|,
    1): the same f32 formulas, summed in other orders (cuBLAS and the
    kernels against the CPU's BLAS and the plain versions) over d_model
    2560-7168 and d_ff 6400-20480, through random-weight layers; 1.3e-3
    was measured on an H100 for zamba2.  An MoE arch runs (b) at its own
    capacity factor (1.25), and (c) every token's top-k experts in every
    MoE layer and the set of dropped assignments equal on the card and on
    the CPU (differences counted, 0 required)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model, moe

    def prefill(params, cfg, batch, dev):
        routes = []
        with moe.observe(lambda idx, keep, cap: routes.append(
                (idx.cpu(), keep.cpu()))):
            logits, _, _ = model.prefill(
                params, {"tokens": batch.to(dev)}, cfg,
                model.init_cache(cfg, 1, 64, dev))
        return logits, routes

    out = {}
    for arch, cut in SERVE_CHECKS:
        t0 = time.perf_counter()
        cfg = configs.get(arch).replace(dtype="float32", **cut)
        # (a) at a capacity at which nothing drops (E / k: each expert may
        # take every token)
        cfg_a = (cfg.replace(capacity_factor=cfg.n_experts / cfg.moe_top_k)
                 if cfg.n_experts else cfg)
        srv = serve.LMServer(cfg_a, max_len=64, seed=5)
        prompt = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                   (1, 40))
        drops = []
        with moe.observe(lambda idx, keep, cap: drops.append(
                (~keep).sum())):
            gen = srv.generate(prompt, 4)
            toks, want = prompt.copy(), []
            for _ in range(4):
                logits, _, _ = model.forward(
                    srv.params,
                    {"tokens": torch.as_tensor(toks, device="cuda")}, cfg_a)
                want.append(int(logits[0, -1, :cfg.vocab_size].argmax()))
                toks = np.concatenate([toks, [[want[-1]]]], 1)
        if gen[0].tolist() != want:
            raise AssertionError(f"{arch}: greedy tokens {gen[0].tolist()} "
                                 f"!= teacher-forced {want}")
        n_drops = int(sum(int(d) for d in drops))
        if n_drops:
            raise AssertionError(f"{arch}: {n_drops} assignments dropped at "
                                 f"capacity factor {cfg_a.capacity_factor}")

        batch = torch.as_tensor(prompt)
        card, card_routes = prefill(srv.params, cfg, batch, "cuda")
        cpu_params = model.LM(cfg, "cpu")
        cpu_params.load_state_dict(srv.params.state_dict())
        del srv
        cpu, cpu_routes = prefill(cpu_params, cfg, batch, "cpu")
        del cpu_params
        err = float(((card.cpu() - cpu).abs()
                     / cpu.abs().clamp_min(1.0)).max())
        if not (torch.isfinite(card).all() and err <= 5e-3):
            raise AssertionError(f"{arch}: card vs CPU prefill logits: "
                                 f"{err} > 5e-3")
        seconds = time.perf_counter() - t0
        rec = dict(layers=cfg.n_layers, tokens=gen[0].tolist(),
                   prefill_logits_err=err, seconds=seconds)
        if cfg.n_experts:
            if len(card_routes) != len(cpu_routes) or not card_routes:
                raise AssertionError(f"{arch}: {len(card_routes)} MoE layers "
                                     f"routed on the card, "
                                     f"{len(cpu_routes)} on the CPU")
            rec.update(
                experts=cfg.n_experts, drops_at_no_drop_capacity=n_drops,
                routing_diffs=sum(int((a[0] != b[0]).sum())
                                  for a, b in zip(card_routes, cpu_routes)),
                dropped_diffs=sum(int((a[1] != b[1]).sum())
                                  for a, b in zip(card_routes, cpu_routes)),
                dropped=sum(int((~b[1]).sum()) for b in cpu_routes),
                assignments=sum(b[1].numel() for b in cpu_routes))
            if rec["routing_diffs"] or rec["dropped_diffs"]:
                raise AssertionError(f"{arch}: routing differs card vs CPU: "
                                     f"{rec['routing_diffs']} top-k "
                                     f"indices, {rec['dropped_diffs']} "
                                     f"drops")
        log("serve_check", arch=arch, teacher_forced="equal",
            prefill_logits_err=f"{err:.3g}", seconds=f"{seconds:.3f}",
            **{k: v for k, v in rec.items()
               if k not in ("prefill_logits_err", "seconds")})
        out[arch] = rec
    for arch in EMBED_CHECKS:
        out[arch] = _embedding_decode_check(arch)
    return out


def _embedding_decode_check(arch: str) -> dict:
    """An embedding-input arch, f32 at full width, EMBED_CHECK_LAYERS
    deep: a prefill of EMBED_CHECK_PROMPT embeddings and
    EMBED_CHECK_DECODE cached decode steps of one embedding [1, 1, D]
    each, all from a seed (the reference's path for these archs:
    `_inputs_to_hidden` and `decode_step` on [B, 1, D]; its server feeds
    token ids only, so no server runs here).  (a) Each decode step's
    logits equal the teacher-forced forward's over all the positions, at
    tests/test_models.py's decode-equivalence tolerance (2e-3 absolute and
    relative).  (b) The prefill's logits, relative to max(|x|, 1): the
    card's no further from the same model in float64 on the CPU than
    max(5e-4, 2x the CPU's own f32 logits), and within serve_check's 5e-3
    of the CPU's.  The reference's init saturates these MHA softmaxes
    (scores of std ~96 at phi-3's widths), so two f32 forwards part by
    more than 5e-4 (2.07e-3 card vs CPU for phi-3-vision on an H100
    80GB HBM3 at 700 W, as yi-34b's 2.36e-3); the float64 forward says
    which of them is off.  The attention launches of (a) are counted:
    one per layer a pass."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model

    t0 = time.perf_counter()
    cfg = configs.get(arch).replace(dtype="float32",
                                    n_layers=EMBED_CHECK_LAYERS)
    total = EMBED_CHECK_PROMPT + EMBED_CHECK_DECODE
    g = torch.Generator().manual_seed(11)
    emb = torch.randn(1, total, cfg.d_model, generator=g)
    params = model.init_params(cfg, 5, "cuda")
    card = emb.to("cuda")
    fa.reset_launches()
    with torch.no_grad():
        full, _, _ = model.forward(params, {"embeddings": card}, cfg)
        cache = model.init_cache(cfg, 1, total, "cuda")
        prefill, cache, _ = model.prefill(
            params, {"embeddings": card[:, :EMBED_CHECK_PROMPT]}, cfg, cache)
        decode_err = 0.0
        for pos in range(EMBED_CHECK_PROMPT, total):
            step, cache = model.decode_step(
                params, {"embeddings": card[:, pos:pos + 1]}, cfg, cache,
                pos)
            want = full[:, pos]
            if not (torch.isfinite(step).all() and torch.allclose(
                    step, want, atol=2e-3, rtol=2e-3)):
                raise AssertionError(f"{arch}: cached decode at {pos} off "
                                     f"the teacher-forced forward by "
                                     f"{max_err(step, want)}")
            decode_err = max(decode_err, max_err(step, want))
    launches = dict(fa.launches)
    if launches["flash_attention"] < 2 * cfg.n_layers:
        raise AssertionError(f"{arch}: attention launches {launches}")
    state = {k: v.cpu() for k, v in params.state_dict().items()}
    del params, cache

    def cpu_prefill(c):
        m = model.LM(c, "cpu")
        m.load_state_dict({k: v.to(c.activation_dtype)
                           for k, v in state.items()})
        with torch.no_grad():
            logits, _, _ = model.prefill(
                m, {"embeddings": emb[:, :EMBED_CHECK_PROMPT].to(
                    c.activation_dtype)}, c,
                model.init_cache(c, 1, total, "cpu"))
        return logits

    def rel(a, b):
        return float(((a.double() - b.double()).abs()
                      / b.double().abs().clamp_min(1.0)).max())

    cpu = cpu_prefill(cfg)
    f64 = cpu_prefill(cfg.replace(dtype="float64"))
    card = prefill.cpu()
    err, card_f64, cpu_f64 = rel(card, cpu), rel(card, f64), rel(cpu, f64)
    if not (torch.isfinite(card).all() and err <= 5e-3
            and card_f64 <= max(5e-4, 2 * cpu_f64)):
        raise AssertionError(
            f"{arch}: prefill logits on embeddings: card vs CPU {err} "
            f"(limit 5e-3), card vs float64 {card_f64} against the CPU's "
            f"{cpu_f64} (limit max(5e-4, 2x))")
    rec = dict(layers=cfg.n_layers, prompt=EMBED_CHECK_PROMPT,
               decode_steps=EMBED_CHECK_DECODE,
               decode_max_abs_err=decode_err, prefill_logits_err=err,
               prefill_card_f64_err=card_f64, prefill_cpu_f64_err=cpu_f64,
               launches=launches, seconds=time.perf_counter() - t0)
    log("serve_check", arch=arch, inputs="embeddings",
        layers=cfg.n_layers, prompt=EMBED_CHECK_PROMPT,
        decode_steps=EMBED_CHECK_DECODE, cached_decode="equal",
        decode_max_abs_err=f"{decode_err:.3g}",
        prefill_logits_err=f"{err:.3g}", card_f64_err=f"{card_f64:.3g}",
        cpu_f64_err=f"{cpu_f64:.3g}", seconds=f"{rec['seconds']:.3f}",
        **launches)
    return rec


TRAIN_ARCH = "starcoder2-3b"
# zamba2-2.7b trains beside it at its published widths and depth (54
# Mamba2 layers in 9 groups, each with the shared attention block), its
# SSD's gradient through the backward kernel; its card-vs-CPU step is one
# group deep
ZAMBA_TRAIN_ARCH = "zamba2-2.7b"
ZAMBA_CPU_LAYERS = 6
# rwkv6-3b trains after them at its published widths and depth (32 layers,
# 40 WKV heads of 64), its WKV's gradient through the backward kernel; its
# card-vs-CPU step is 2 layers deep
RWKV_TRAIN_ARCH = "rwkv6-3b"
RWKV_CPU_LAYERS = 2
# phi-3-vision-4.2b and musicgen-large train last at their published widths
# and depth on the frontends' embeddings (32 layers of 32 MHA heads of 96;
# 48 layers of 32 MHA heads of 64 at accum_steps 2); each card-vs-CPU step
# is TRAIN_CPU_LAYERS deep
PHI3_TRAIN_ARCH = "phi-3-vision-4.2b"
MUSICGEN_TRAIN_ARCH = "musicgen-large"
# dbrx-132b trains last at its published widths, all 16 experts, top-4,
# cut to 1 layer: 4.49 B parameters, whose bf16 weights and gradients and
# f32 moments take 53.9 GB (50.2 GiB) before any activation; 2 layers
# (7.75 B, 93 GB) do not fit the card.  It runs at accum_steps 1, not its
# published 4: B 2 does not split into 4 microbatches, and at B 4 the f32
# gradient accumulator (18 GB) and its division (18 GB more in transit)
# do not fit beside the 53.9 GB.  Its card-vs-CPU step is 1 layer deep
# with 8 of the 16 experts, top-4 kept (2.91 B, 10.83 GiB in f32): with
# all 16 (16.7 GiB) the step's f32 and f64 copies on the host would come
# to about 167 GiB.
DBRX_TRAIN_ARCH = "dbrx-132b"
DBRX_TRAIN_CUT = dict(n_layers=1)
DBRX_CPU_CUT = dict(n_layers=1, n_experts=8)
# deepseek-v3-671b trains after it at its published widths (d_model 7168,
# MLA with 128 heads of 192 -> 128, vocab 129,280, the sigmoid router,
# top-8, one shared expert, capacity factor 1.25, MTP depth 1, bf16
# moments), cut in three ways: (1) to MOE_SERVE_LAYERS = 4 layers with its
# first_k_dense 3 kept (3 dense MLA layers and 1 MoE layer, as it is
# served); (2) to 32 of its 256 routed experts, as serve_check cuts it:
# 5.93 B parameters, whose bf16 weights, gradients and moments take 44.2
# GiB before any activation (64 experts: 54.7 GiB; the 61-layer model does
# not fit one card); (3) to accum_steps 1, not its published 8: B 2 does
# not split into 8 microbatches.  Its card-vs-CPU step is 1 layer deep,
# first_k_dense 0 (the MoE layer; the MTP block's dense layer carries MLA
# and the dense SwiGLU), with 16 of the 256 experts, top-8 kept (16 > 8,
# so routing still chooses), MTP on: 3.48 B parameters, about 65 GiB of
# host for the step's f32 and f64 copies.
DEEPSEEK_TRAIN_ARCH = "deepseek-v3-671b"
DEEPSEEK_TRAIN_CUT = dict(n_layers=MOE_SERVE_LAYERS, first_k_dense=3,
                          n_experts=32)
DEEPSEEK_CPU_CUT = dict(n_layers=1, first_k_dense=0, n_experts=16)
# The cost phase's cells: each train run's arch, the key of its record in
# the train phase's output (None: the output itself) and its config cut
COST_RUNS = ((TRAIN_ARCH, None, {}), (ZAMBA_TRAIN_ARCH, "zamba2", {}),
             (RWKV_TRAIN_ARCH, "rwkv6", {}),
             (PHI3_TRAIN_ARCH, PHI3_TRAIN_ARCH, {}),
             (MUSICGEN_TRAIN_ARCH, MUSICGEN_TRAIN_ARCH, {}),
             (DBRX_TRAIN_ARCH, DBRX_TRAIN_ARCH, DBRX_TRAIN_CUT),
             (DEEPSEEK_TRAIN_ARCH, DEEPSEEK_TRAIN_ARCH, DEEPSEEK_TRAIN_CUT))
COST_PEAK_TOL = 0.10          # predicted peak against the measured one
TRAIN_STEPS = 6
TRAIN_BATCH = 2
TRAIN_SEQ = 1024
TRAIN_CKPT_EVERY = 3
# The checkpoint and resume run at a depth cut: a full-depth train state
# (bf16 parameters staged as f32, f32 moments) is 38 GB per checkpoint,
# and the card's host keeps its disk in memory, so two checkpoints and a
# staged copy do not fit beside the run.  The widths stay published.
TRAIN_CKPT_LAYERS = 2
TRAIN_CPU_LAYERS = 2         # the card-vs-CPU step: f32, full width
TRAIN_CPU_SEQ = 128
# The card-vs-CPU step's gradient limits: relative L2 gap per tensor,
# the first pattern that matches the tensor's name.  They go by the
# number of saturated softmaxes the tensor's gradient goes back through.
# The reference's init, which the port copies, draws a [d, heads,
# head_dim] projection with the head count as its fan-in, so w_k (2 kv
# heads) has std 0.71 and w_q (24 heads) 0.20; the scores reach hundreds
# and every softmax saturates.  Any f32 gradient is then 1e-5 to 1e-2 off
# the exact one, whatever the order of its sums: the CPU's own reads
# 1.6e-5 to 1.0e-2 from float64, so 1e-5 between two f32 runs cannot
# hold.  Each limit is about 3x the largest card-vs-CPU gap over three
# seeds and below the smallest gap of the card with TF32 GEMMs, a control
# of lower precision (train_grad_readings.py on an NVIDIA H100 80GB HBM3
# at 700 W: the numbers beside each pattern).
TRAIN_GRAD_LIMITS = (
    # back through layer 1's and layer 0's scores: <= 1.34e-2, TF32 >= 1.52
    (r"embedding|layers\.0\.(norm1|attn\.w_[qk])", 4e-2),
    # back through one layer's scores: <= 4.60e-3, TF32 >= 0.693
    (r"layers\.0\..*|layers\.1\.(norm1|attn\.w_[qk])", 1.5e-2),
    # through none, the forward's error alone: <= 3.11e-4, TF32 >= 2.64e-3
    (r".*", 1e-3),
)


# zamba2's card-vs-CPU step (one group: 6 Mamba2 layers and the shared
# attention block, f32): relative L2 gap per tensor, the first pattern
# that matches the tensor's name, set as TRAIN_GRAD_LIMITS are: about 3x
# the largest card-vs-CPU gap over three seeds and below the smallest gap
# of the TF32 control (train_grad_readings.py --arch zamba2-2.7b on an
# NVIDIA H100 80GB HBM3 at 700 W: the numbers beside each pattern).  As
# in starcoder2, the gap goes by whether the gradient comes back through
# the attention's scores: the shared block's value path, its MLP and the
# head do not; its query and key projections, its first norm, every
# Mamba2 layer and the embedding do.  The CPU's own f32 gradient is
# 1.1e-4 to 1.7e-4 from float64 on the latter.
ZAMBA_GRAD_LIMITS = (
    # not through the scores: <= 4.73e-5, TF32 >= 1.33e-2
    (r"final_norm|lm_head|shared_attn\.(norm2|attn\.w_[vo]|mlp\..*)",
     1.5e-4),
    # through the shared block's scores: <= 2.75e-4, TF32 >= 7.70e-2
    (r".*", 8e-4),
)


# rwkv6's card-vs-CPU step (2 layers, f32): relative L2 gap per tensor,
# the first pattern that matches the tensor's name, set as
# TRAIN_GRAD_LIMITS are: about 3x the largest card-vs-CPU gap over three
# seeds and below the smallest gap of the TF32 control
# (train_grad_readings.py --arch rwkv6-3b on an NVIDIA H100 80GB HBM3 at
# 700 W: the numbers beside each pattern).  No softmax saturates here; the
# gap goes by whether the gradient comes back through layer 1's receptance
# and key path (r, k, u, their mixes and norm) into layer 0.  The CPU's own
# f32 gradient is as far from float64 as the card's on every tensor.
RWKV_GRAD_LIMITS = (
    # the head, both layers' decay and layer 1's value, gate, output and
    # channel mix: <= 6.12e-6, TF32 >= 1.86e-3
    (r"final_norm|lm_head|layers\.\d+\.decay_.*"
     r"|layers\.1\.(w_[vgo]|cmix_.*|cw_.*|ln2_.*|gn_.*)", 2e-5),
    # layer 1's r, k, u and their mixes and norm, layer 0 and the
    # embedding: <= 4.20e-4, TF32 >= 6.34e-3
    (r".*", 1.3e-3),
)


# phi-3-vision's and musicgen's card-vs-CPU steps (2 layers, f32, on
# embeddings): relative L2 gap per tensor, the first pattern that matches
# the tensor's name, set as TRAIN_GRAD_LIMITS are: about 3x the largest
# card-vs-CPU gap over three seeds and below the smallest gap of the TF32
# control (train_grad_readings.py --arch phi-3-vision-4.2b / --arch
# musicgen-large on an NVIDIA H100 80GB HBM3 at 700 W: the numbers beside
# each pattern).  As in starcoder2, the gap goes by whether the gradient
# comes back through the attention's scores; with 32 MHA heads (fan-in
# 32 for w_q and w_k alike) the scores saturate less than starcoder2's
# (w_k over 2 kv heads), so the gaps are smaller.  The CPU's own f32
# gradient is as far from float64 as the card's on every tensor.  The
# embedding table, which the loss does not reach, is held to zero.
PHI3_GRAD_LIMITS = (
    # back through the scores: <= 8.38e-4, TF32 >= 0.265
    (r"layers\.0\..*|layers\.1\.(norm1|attn\.w_[qk])", 2.5e-3),
    # through none: <= 1.00e-4, TF32 >= 2.73e-2
    (r".*", 3e-4),
)
MUSICGEN_GRAD_LIMITS = (
    # back through the scores: <= 2.16e-4, TF32 >= 0.154
    (r"layers\.0\..*|layers\.1\.(norm1|attn\.w_[qk])", 6.5e-4),
    # through none: <= 2.32e-5, TF32 >= 1.25e-3
    (r".*", 7e-5),
)

# dbrx-132b's card-vs-CPU step (1 layer, 8 of its 16 experts, top-4, f32):
# relative L2 gap per tensor, the first pattern that matches the tensor's
# name, set as TRAIN_GRAD_LIMITS are: about 3x the largest card-vs-CPU gap
# over three seeds and below the smallest gap of the TF32 control
# (train_grad_readings.py --arch dbrx-132b on an NVIDIA H100 80GB HBM3 at
# 700 W: the numbers beside each pattern).  As in starcoder2, the gap goes
# by whether the gradient comes back through the attention's scores (48
# query heads over 8 kv heads); the MoE's tensors (norm2, router, the
# expert stacks) read 2.4e-5 to 2.6e-5, the head and the value path
# 1.4e-5 to 1.5e-5.  The CPU's own f32 gradient is as far from float64 as
# the card's on every tensor.
DBRX_GRAD_LIMITS = (
    # back through the scores: <= 2.19e-4, TF32 >= 6.97e-2
    (r"embedding|moe\.0\.(norm1|attn\.w_[qk])", 7e-4),
    # through none: <= 2.57e-5, TF32 >= 6.19e-3
    (r".*", 8e-5),
)

# deepseek-v3-671b's card-vs-CPU step (DEEPSEEK_CPU_CUT: its MoE layer and
# the MTP block, 16 of 256 experts, top-8, f32): relative L2 gap per
# tensor, the first pattern that matches the tensor's name, set as
# TRAIN_GRAD_LIMITS are: about 3x the largest card-vs-CPU gap over three
# seeds and below the smallest gap of the TF32 control
# (train_grad_readings.py --arch deepseek-v3-671b on an NVIDIA H100 80GB
# HBM3 at 700 W: the numbers beside each pattern).  No softmax saturates
# as starcoder2's do (128 MLA heads, each projection's fan-in 128): every
# tensor reads 3.4e-6 to 8.7e-6, about twice the CPU's own distance from
# float64 (at most 4.0e-6).  The MTP block's tensors, whose gradient comes
# back through its layer and the shared head, read the most.
DEEPSEEK_GRAD_LIMITS = (
    # the MTP block: <= 8.66e-6, TF32 >= 1.72e-3
    (r"mtp\..*", 2.6e-5),
    # the MoE layer, the head and the embedding: <= 7.05e-6, TF32 >= 1.40e-3
    (r".*", 2.1e-5),
)


def _depth_cut(arch: str, **cut) -> str:
    """Register `arch` with the config fields in `cut` replaced (its depth
    `n_layers`, and for an MoE arch its leading dense layers or its expert
    count, as SERVE_CHECKS cuts), its widths kept, under a new name that
    the port's `train()` and servers take (as examples/train_lm.py
    registers its config): `<arch>-<n>l`, then `-<field><value>` for each
    other field."""
    import types
    from repro_torch import configs
    name = f"{arch}-{cut['n_layers']}l" + "".join(
        f"-{k}{v}" for k, v in sorted(cut.items()) if k != "n_layers")
    mod = types.ModuleType(f"chip_smoke_{name}")
    mod.CONFIG = mod.REDUCED = configs.get(arch).replace(name=name, **cut)
    sys.modules[mod.__name__] = mod
    configs._MODULES[name] = mod.__name__
    return name


def _train_step_profile(out, cfg, seed):
    """One more train step on the run's final state, outside the counted
    run, under the profiler: device busy ms, the idle share of the step's
    wall time and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _to_device
    from repro_torch.optim import AdamWConfig
    step = make_train_step(cfg, AdamWConfig(moments_dtype=cfg.moments_dtype,
                                            total_steps=TRAIN_STEPS))
    pipe = make_pipeline("synthetic", vocab_size=cfg.vocab_size,
                         seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                         seed=seed, embeddings_dim=_embeddings_dim(cfg))
    batch = _to_device(pipe.batch(TRAIN_STEPS), torch.device("cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(out["params"], out["opt_state"], batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _device_busy_ms(prof)
    idle = None if busy <= 0.0 else 1 - busy / (wall * 1e3)

    def kernel_ms(*names):
        return sum(e.self_device_time_total for e in _kernel_events(prof)
                   if any(k in e.key for k in names)) / 1e3

    def kernel_calls(*names):
        """Launches of the named kernels (a backward call is 3 or 4)."""
        return sum(e.count for e in _kernel_events(prof)
                   if any(k in e.key for k in names))

    # the attention forward's kernel (flash_attention_kernel or
    # flash_attention_bf16_kernel) and its backward's (flash_attention_bwd_*),
    # and the SSD's and the WKV's forward and backward kernels, each summed
    attn_fwd_names = ("flash_attention_kernel", "flash_attention_bf16_kernel")
    attn_fwd = kernel_ms(*attn_fwd_names)
    attn_bwd = kernel_ms("flash_attention_bwd")
    ssd_bwd = kernel_ms(*SSD_BWD_PHASES)
    ssd_fwd = kernel_ms(*SSD_PHASES)
    wkv_bwd = kernel_ms(*WKV_BWD_PHASES)
    wkv_fwd = kernel_ms(*WKV_PHASES)
    seen = busy > 0.0
    return dict(wall_ms=wall * 1e3,
                device_busy_ms=busy if seen else None,
                device_idle_share=idle,
                attention_fwd_ms=attn_fwd if seen else None,
                attention_fwd_kernels=kernel_calls(*attn_fwd_names),
                attention_bwd_ms=attn_bwd if seen else None,
                attention_bwd_kernels=kernel_calls(*ATTN_BWD_PHASES,
                                                   ATTN_BWD_REDUCE),
                ssd_bwd_ms=ssd_bwd if seen else None,
                ssd_fwd_ms=ssd_fwd if seen else None,
                ssd_bwd_share_of_busy=ssd_bwd / busy if seen else None,
                wkv_bwd_ms=wkv_bwd if seen else None,
                wkv_fwd_ms=wkv_fwd if seen else None,
                wkv_bwd_share_of_busy=wkv_bwd / busy if seen else None,
                top_device_ops=_top_device_ops(prof, 8))


def _embeddings_dim(cfg) -> int:
    """The pipeline's embeddings width for `cfg`, as train() sets it."""
    return cfg.d_model if cfg.input_mode == "embeddings" else 0


def _train_launches_want(cfg) -> dict:
    """The LM kernels' launches a TRAIN_STEPS-step run of `cfg` must make
    under the port's remat (torch.utils.checkpoint: a checkpointed
    function's forward runs again in the backward, before its backward),
    in each of the step's `accum_steps` microbatches.
    A stack of layers checkpoints each layer: its forward twice a step,
    its backward once.  deepseek-v3's MTP layer is not checkpointed: its
    attention forward and backward once a step each (4 layers deep: 2 x 4
    + 1 = 9 forwards and 4 + 1 = 5 backwards a step).  zamba2's remat is
    nested, as the reference's is
    (repro/models/model.py:155-158): each group of Mamba2 layers and the
    shared attention block is checkpointed, and inside the group's
    recompute each Mamba2 layer is checkpointed again.  So a Mamba2
    layer's forward runs three times a step (the forward, its group's
    recompute, its own recompute) and the shared block's twice.  rwkv6's
    layers are checkpointed one by one: each WKV forward twice a step, its
    backward once."""
    steps = TRAIN_STEPS * max(cfg.accum_steps, 1)
    want = {"flash_attention": 0, "flash_attention_bwd": 0,
            "mamba2_ssd": 0, "mamba2_ssd_bwd": 0,
            "rwkv6_wkv": 0, "rwkv6_wkv_bwd": 0}
    if cfg.block_kind == "rwkv6":
        want.update(rwkv6_wkv=2 * cfg.n_layers * steps,
                    rwkv6_wkv_bwd=cfg.n_layers * steps)
    elif cfg.shared_attn_every:
        groups = cfg.n_layers // cfg.shared_attn_every
        want.update(mamba2_ssd=3 * cfg.n_layers * steps,
                    mamba2_ssd_bwd=cfg.n_layers * steps,
                    flash_attention=2 * groups * steps,
                    flash_attention_bwd=groups * steps)
    else:
        # deepseek-v3's MTP block (one dense layer, whatever mtp_depth)
        # runs outside the checkpointed stack (models/model.py `_mtp_loss`,
        # as the reference's): its attention once forward and once
        # backward per microbatch, with no recompute
        mtp = 1 if cfg.mtp_depth else 0
        want.update(flash_attention=(2 * cfg.n_layers + mtp) * steps,
                    flash_attention_bwd=(cfg.n_layers + mtp) * steps)
    return want


def _train_full_depth(arch: str, accum_steps: int = 0):
    """`arch` at its published widths and depth (bf16, remat, its
    published accum_steps unless `accum_steps` is given) through the
    port's `train()`: 6 AdamW steps at B 2, S 1024 on synthetic data
    (token ids, or embeddings for an embedding-input arch).  The
    attention, SSD and WKV launch counters are zeroed just before and read
    just after; they must read `_train_launches_want` exactly.  An MoE
    arch's routing is observed over the run (`_train_moe_stats`)."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.launch.train import train
    from repro_torch.models import model, moe

    cfg = configs.get(arch)
    cfg = cfg.replace(accum_steps=accum_steps or cfg.accum_steps)
    n_params = model.count_params(cfg)
    routes = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved_at_start = torch.cuda.memory_reserved() / 2 ** 30
    before = torch.cuda.memory_stats()
    fa.reset_launches()
    ssd.reset_launches()
    wkv.reset_launches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as watch:
        if cfg.n_experts:
            # kept on the device until the run ends
            watch.enter_context(moe.observe(
                lambda idx, keep, cap: routes.append((idx, keep, cap))))
        out = train(arch, reduced=False, steps=TRAIN_STEPS,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0, log_every=1,
                    accum_steps=cfg.accum_steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    after = torch.cuda.memory_stats()
    # the caching allocator during the run: device allocations it made
    # and frees it had to make (a full cache is emptied and the request
    # retried: a synchronising slow path)
    allocator = {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("num_device_alloc", "num_device_free",
                           "num_alloc_retries")}
    launches = {**fa.launches, **ssd.launches, **wkv.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = _train_launches_want(cfg)
    if launches != want:
        raise AssertionError(f"train {arch}: launches {launches}, expected "
                             f"{want} (_train_launches_want: the remat "
                             f"recomputes)")
    if not (np.isfinite(out["losses"]).all()
            and np.isfinite(out["grad_norms"]).all()):
        raise AssertionError(f"train {arch}: losses {out['losses']} grad "
                             f"norms {out['grad_norms']}")
    # bf16 parameters: a step of lr x delta below half a bf16 step of the
    # parameter rounds back to it, as in the reference, so at warm-up's
    # small lr not every tensor moves; the run must move some
    start = model.init_params(cfg, 0, "cuda")        # the same seed
    moved = max(float((a.detach() - b).abs().max())
                for a, b in zip(out["params"].parameters(),
                                start.parameters()))
    n_moved = sum(not torch.equal(a.detach(), b)
                  for a, b in zip(out["params"].parameters(),
                                  start.parameters()))
    del start
    if not moved > 0:
        raise AssertionError(f"train {arch}: no parameter moved")
    step_ms = float(np.median(out["step_s"][-4:])) * 1e3
    res = dict(
        arch=arch, layers=cfg.n_layers, params=n_params,
        dtype=cfg.dtype, remat=cfg.remat, steps=TRAIN_STEPS,
        accum_steps=cfg.accum_steps, inputs=cfg.input_mode,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=out["losses"],
        grad_norms=out["grad_norms"], step_s=out["step_s"],
        step_ms_median_last4=step_ms,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
        peak_device_gib=peak, run_s=run_s, max_param_move=moved,
        reserved_gib_at_start=reserved_at_start, allocator=allocator,
        tensors_moved=n_moved,
        tensors=len(list(out["params"].parameters())), launches=launches)
    log("train", arch=arch, layers=cfg.n_layers, params=n_params,
        steps=TRAIN_STEPS, accum_steps=cfg.accum_steps,
        inputs=cfg.input_mode,
        losses=[f"{x:.4f}" for x in out["losses"]],
        grad_norms=[f"{x:.3f}" for x in out["grad_norms"]],
        step_ms=f"{step_ms:.2f}",
        tokens_per_s=f"{res['tokens_per_s']:.1f}",
        peak_device_gib=f"{peak:.2f}",
        reserved_gib_at_start=f"{reserved_at_start:.2f}",
        tensors_moved=f"{n_moved}/{res['tensors']}", **launches,
        **allocator)
    if cfg.n_experts:
        res["moe"] = _train_moe_stats(arch, cfg, routes)
    del routes
    res["profiled_step"] = _train_step_profile(out, cfg, 0)
    p = res["profiled_step"]
    log("train.where", arch=arch, wall_ms=f"{p['wall_ms']:.2f}",
        device_busy_ms=p["device_busy_ms"] or "not measured",
        idle_share=p["device_idle_share"]
        if p["device_idle_share"] is not None else "not measured",
        attention_fwd_ms=p["attention_fwd_ms"] or "not measured",
        attention_fwd_kernels=p["attention_fwd_kernels"],
        attention_bwd_ms=p["attention_bwd_ms"] or "not measured",
        attention_bwd_kernels=p["attention_bwd_kernels"],
        ssd_bwd_ms=p["ssd_bwd_ms"] or "not measured",
        ssd_fwd_ms=p["ssd_fwd_ms"] or "not measured",
        wkv_bwd_ms=p["wkv_bwd_ms"] or "not measured",
        wkv_fwd_ms=p["wkv_fwd_ms"] or "not measured")
    for op, ms, calls in p["top_device_ops"]:
        log("train.op", arch=arch, op=repr(op), device_ms=f"{ms:.3f}",
            calls=calls)
    del out
    torch.cuda.empty_cache()
    return res, launches


def _train_moe_stats(arch, cfg, routes):
    """The training run's routing: `routes` holds every observer call,
    (idx, keep, capacity).  Remat "full" runs each MoE layer's forward
    again in the backward, which calls the observers again, so a
    micro-batch's calls are its layers' forwards, then their recomputes in
    reverse order.  Each forward is counted once, and each recompute must
    route as its forward did.  Gives the drop share over the forwards and
    the largest expert load (assignments routed to one expert, before the
    capacity drops them) against the capacity."""
    import torch
    n = cfg.n_layers - cfg.first_k_dense
    per = 2 * n if cfg.remat else n
    calls = TRAIN_STEPS * max(cfg.accum_steps, 1) * per
    if len(routes) != calls:
        raise AssertionError(f"train {arch}: {len(routes)} MoE calls, "
                             f"expected {calls}")
    fwd = []
    for i in range(0, calls, per):
        first, again = routes[i:i + n], routes[i + n:i + per][::-1]
        for (ia, ka, _), (ib, kb, _) in zip(first, again):
            if not (torch.equal(ia, ib) and torch.equal(ka, kb)):
                raise AssertionError(f"train {arch}: a recompute routed "
                                     f"otherwise than its forward")
        fwd += first
    loads = [int(torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
                 .max()) for idx, _, _ in fwd]
    caps = {cap for _, _, cap in fwd}
    dropped = sum(int((~keep).sum()) for _, keep, _ in fwd)
    assignments = sum(keep.numel() for _, keep, _ in fwd)
    out = dict(moe_forwards=len(fwd), observer_calls=calls,
               assignments=assignments, dropped=dropped,
               drop_share=dropped / assignments, max_load=max(loads),
               capacity=max(caps), max_load_over_capacity=max(loads)
               / max(caps), recompute_routes_equal=True)
    log("train.moe", arch=arch, **{k: (f"{v:.6g}" if isinstance(v, float)
                                      else v) for k, v in out.items()})
    return out


def _train_checkpoint_resume():
    """Checkpoints and resume, at full width and TRAIN_CKPT_LAYERS deep:
    (1) an uninterrupted 6-step run; (2) a 3-step run with a checkpoint
    every 3 steps, which writes step 2: restored, it equals the state
    that wrote it bit for bit; (3) `train()` on that directory restores
    step 2 and runs steps 3-5 (writing step 5), and its losses and final
    state are held to (1)'s."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as train_lib

    arch = _depth_cut(TRAIN_ARCH, n_layers=TRAIN_CKPT_LAYERS)
    kw = dict(reduced=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0,
              log_every=TRAIN_STEPS)
    base = ROOT / "build" / "train_ckpt"
    base.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=base))
    try:
        t0 = time.perf_counter()
        whole = train_lib.train(arch, steps=TRAIN_STEPS, **kw)
        whole_s = time.perf_counter() - t0
        kw.update(ckpt_every=TRAIN_CKPT_EVERY)
        first = train_lib.train(arch, steps=TRAIN_CKPT_EVERY,
                                ckpt_dir=str(tmp / "resume"), **kw)
        files = sorted(p.name for p in (tmp / "resume").iterdir())
        if files != ["step_00000002.npz"]:
            raise AssertionError(f"train checkpoints: {files}")
        ckpt_bytes = (tmp / "resume" / files[0]).stat().st_size
        named = dict(first["params"].named_parameters())
        t0 = time.perf_counter()
        restored, meta = CheckpointManager(tmp / "resume").restore(
            TRAIN_CKPT_EVERY - 1,
            train_lib.state_like(named, first["opt_state"]), device="cuda")
        restore_s = time.perf_counter() - t0
        fresh = {k: torch.empty_like(v) for k, v in named.items()}
        fresh_opt = {"m": {k: torch.empty_like(v) for k, v in
                           first["opt_state"]["m"].items()},
                     "v": {k: torch.empty_like(v) for k, v in
                           first["opt_state"]["v"].items()},
                     "step": torch.zeros((), dtype=torch.int32,
                                         device="cuda")}
        train_lib.load_state(fresh, fresh_opt, restored)
        del restored
        bad = [k for k, v in named.items()
               if not torch.equal(fresh[k], v.detach())]
        bad += [f"{part}.{k}" for part in ("m", "v")
                for k, v in first["opt_state"][part].items()
                if not torch.equal(fresh_opt[part][k], v)]
        if bad or int(fresh_opt["step"]) != TRAIN_CKPT_EVERY or \
                meta["step"] != TRAIN_CKPT_EVERY - 1:
            raise AssertionError(f"train: restored step 2 differs from the "
                                 f"saved state in {bad[:5]}")
        del fresh, fresh_opt, first, named

        resumed = train_lib.train(arch, steps=TRAIN_STEPS,
                                  ckpt_dir=str(tmp / "resume"), **kw)
        files = sorted(p.name for p in (tmp / "resume").iterdir())
        if files != ["step_00000002.npz", "step_00000005.npz"]:
            raise AssertionError(f"train checkpoints after the resume: "
                                 f"{files}")
        want = whole["losses"][TRAIN_CKPT_EVERY:]
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(resumed["losses"], want))
        param_err = max(float((a.detach().float() - b.detach().float())
                              .abs().max())
                        for a, b in zip(resumed["params"].parameters(),
                                        whole["params"].parameters()))
        # bitwise: a resumed step starts from the saved state bit for bit
        # (checked above), the batch of a step depends on the step alone,
        # and the step is deterministic on one card: the attention kernels
        # sum in a fixed order with no atomics, cuBLAS takes the same
        # algorithm for the same shapes, and the embedding's gradient
        # (index_put_ with accumulate) sorts its indices before it sums
        bitwise = resumed["losses"] == want and all(
            torch.equal(a, b) for a, b in zip(resumed["params"].parameters(),
                                              whole["params"].parameters()))
        if not bitwise:
            raise AssertionError(f"train resume: losses {resumed['losses']} "
                                 f"against {want} ({loss_rel}), parameters "
                                 f"{param_err} apart; not bit for bit")
        res = dict(layers=TRAIN_CKPT_LAYERS, whole_losses=whole["losses"],
                   resumed_losses=resumed["losses"], loss_rel=loss_rel,
                   max_param_err=param_err, bitwise=bitwise,
                   checkpoint_bytes=ckpt_bytes, whole_run_s=whole_s,
                   restore_s=restore_s, restored_bit_exact=True)
        log("train.checkpoint", layers=TRAIN_CKPT_LAYERS,
            checkpoint_gb=f"{ckpt_bytes / 1e9:.2f}",
            restored_step2="bit-exact", restore_s=f"{restore_s:.2f}",
            resumed_losses=[f"{x:.6f}" for x in resumed["losses"]],
            uninterrupted=[f"{x:.6f}" for x in want],
            loss_rel=f"{loss_rel:.3g}", max_param_err=f"{param_err:.3g}",
            bitwise=bitwise)
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _host_mem_available_gib() -> float:
    """The host's MemAvailable (/proc/meminfo), GiB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2 ** 20
    return float("nan")


def _train_step_grads(seed: int = 7, tok_seed: int = 9,
                      repeat: bool = False, arch: str = TRAIN_ARCH,
                      cut=None) -> dict:
    """One train step of `arch` (starcoder2-3b, zamba2-2.7b, rwkv6-3b,
    phi-3-vision-4.2b, musicgen-large, dbrx-132b or deepseek-v3-671b) at
    full width with the config fields in `cut` replaced (its depth, and
    for an MoE arch its leading dense layers and its expert count, its
    top-k kept; TRAIN_CPU_LAYERS deep where no cut is given),
    in f32, from the same parameters (drawn from
    `seed`) and batch (from `tok_seed`: token ids, or embeddings and
    labels for an embedding-input arch): the gradient of `loss_fn`, then
    `adamw_update` (the train step at one micro-batch), on the card and
    through the port on the CPU; the same gradient on the card with TF32
    GEMMs (a control of lower precision) and of the same model in float64
    on the CPU (the oracle).  Returns the metrics (loss, aux, lr, gradient
    norm, and deepseek-v3's MTP cross-entropy), each tensor's relative L2
    gradient gaps (`card_cpu`,
    `tf32_cpu`, `card_f64`, `cpu_f64`, and `norm`, the CPU gradient's),
    the largest gap of the updated parameters, the MoE forwards' routing
    differences from the CPU's (top-k indices and kept assignments; none
    for a dense arch), and with `repeat` whether a second card gradient
    equals the first bit for bit.  Each gradient stays where it was made
    (the oracle's and the CPU's on the host, the card's and the control's
    on the card) and the gaps are read one tensor at a time on the card,
    so the host holds at most the f32 model, the f64 model and its
    gradient, five f32 copies of the parameters (54 GiB at dbrx-132b's
    cut, 65 GiB at deepseek-v3's), and the card four.  `host_s` splits
    the host's wall seconds into the stages: `init` (the f32 model and the
    batch), `f64` (the oracle's model and gradient), `card` (the card's
    model, the TF32 control's gradient, the card's and its repeat),
    `cpu` (the CPU's gradient), `gaps` (each tensor's gaps and the routing
    differences) and `adamw` (both updates and the parameters' gap), which
    sum to `total`; `host_mem_available_gib` is the host's
    MemAvailable before the step and `host_peak_rss_gib` the process's
    peak resident size after it.  train_grad_readings.py records these
    over several seeds."""
    import resource
    import numpy as np
    import torch
    from repro_torch import configs, device
    from repro_torch.models import model, moe
    from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state

    host_s = {}
    t_all = t_stage = time.perf_counter()

    def stage(name):
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        host_s[name] = now - t_stage
        t_stage = now

    mem_available = _host_mem_available_gib()
    cfg = configs.get(arch).replace(
        dtype="float32", **(cut or dict(n_layers=TRAIN_CPU_LAYERS)))
    n_moe = cfg.n_layers - cfg.first_k_dense if cfg.n_experts else 0
    cpu = model.init_params(cfg, seed, "cpu").trainable()
    rng = np.random.default_rng(tok_seed)
    if cfg.input_mode == "embeddings":
        batch = {"embeddings": torch.as_tensor(rng.standard_normal(
                     (TRAIN_BATCH, TRAIN_CPU_SEQ, cfg.d_model)),
                     dtype=torch.float32),
                 "labels": torch.as_tensor(rng.integers(
                     0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_CPU_SEQ)))}
    else:
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_CPU_SEQ)))}
    stage("init")

    def grad(m, c):
        """-> (named parameters, loss, {"aux"[, "mtp_ce"]}, gradients,
        routes): routes are the forward's (idx, keep) per MoE layer, on
        the host (remat's recompute calls the observer again after
        them)."""
        named = dict(m.named_parameters())
        dev = next(m.parameters()).device
        seen = []
        with moe.observe(lambda idx, keep, cap: seen.append(
                (idx.cpu(), keep.cpu()))):
            # the embeddings in the model's dtype (float64 for the oracle)
            loss, met = model.loss_fn(m, {k: v.to(dev, c.activation_dtype)
                                          if v.is_floating_point()
                                          else v.to(dev)
                                          for k, v in batch.items()}, c)
            # the embedding table of an embedding-input arch is not
            # reached: a zero gradient, as train() takes it
            g = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True, materialize_grads=True)
        return (named, float(loss.detach()),
                {k: float(met[k].detach()) for k in ("aux", "mtp_ce")
                 if k in met}, dict(zip(named, g)), seen[:n_moe])

    metrics, out = {}, {}
    # the oracle first: its model is gone before the other gradients exist
    cfg64 = cfg.replace(dtype="float64")
    cpu64 = model.LM(cfg64, "cpu")
    src = dict(cpu.named_parameters())
    with torch.no_grad():
        for k, p64 in cpu64.named_parameters():
            p64.copy_(src[k])
    _, loss, extra, g64, r64 = grad(cpu64.trainable(), cfg64)
    del cpu64, src
    metrics["cpu_f64"] = dict(loss=loss, **extra, grad_norm=math.sqrt(
        sum(float(v.square().sum()) for v in g64.values())))
    stage("f64")

    card = model.LM(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    card.trainable()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, loss, _, g_tf32, r_tf32 = grad(card, cfg)
    finally:
        device.strict_numerics()
    metrics["card_tf32"] = dict(loss=loss)
    card_named, loss, extra, g_card, r_card = grad(card, cfg)
    if repeat:
        _, loss2, _, g2, _ = grad(card, cfg)
        out["repeat_bitwise"] = loss2 == loss and all(
            torch.equal(g_card[k], g2[k]) for k in g_card)
        del g2
    metrics["card"] = dict(loss=loss, **extra)
    stage("card")
    cpu_named, loss, extra, g_cpu, r_cpu = grad(cpu, cfg)
    metrics["cpu"] = dict(loss=loss, **extra)
    stage("cpu")

    def gap(a, b):
        n = float(torch.linalg.vector_norm(b.double()))
        d = float(torch.linalg.vector_norm(a.double() - b.double()))
        return d / n if n > 0 else d

    out["tensors"] = {}
    for k in g64:
        c, f = g_cpu[k].cuda(), g64[k].cuda()
        out["tensors"][k] = dict(
            card_cpu=gap(g_card[k], c), tf32_cpu=gap(g_tf32[k], c),
            card_f64=gap(g_card[k], f), cpu_f64=gap(c, f),
            norm=float(torch.linalg.vector_norm(c.double())))
        del c, f
    del g_tf32, g64

    def differ(a, b):
        return dict(idx=sum(int((x[0] != y[0]).sum()) for x, y in zip(a, b)),
                    keep=sum(int((x[1] != y[1]).sum())
                             for x, y in zip(a, b)))

    out["routing"] = dict(
        moe_layers=n_moe, assignments=sum(r[1].numel() for r in r_cpu),
        dropped_cpu=sum(int((~r[1]).sum()) for r in r_cpu),
        card_cpu=differ(r_card, r_cpu), f64_cpu=differ(r64, r_cpu),
        tf32_cpu=differ(r_tf32, r_cpu))
    stage("gaps")
    for name, named, g in (("card", card_named, g_card),
                           ("cpu", cpu_named, g_cpu)):
        _, _, met = adamw_update(named, g, init_opt_state(
            named, AdamWConfig()), AdamWConfig())
        metrics[name].update({k: float(v) for k, v in met.items()})
    del g_card, g_cpu
    out["metrics"] = metrics
    # read on the card, a tensor at a time: the same exact differences,
    # without a host copy and a host subtraction of every parameter
    out["max_param_err"] = max(
        float((a.detach() - b.detach().cuda()).abs().max())
        for a, b in zip(card.parameters(), cpu.parameters()))
    stage("adamw")
    host_s["total"] = time.perf_counter() - t_all
    out.update(host_s=host_s, host_mem_available_gib=mem_available,
               host_peak_rss_gib=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
               cut=dict(cfg=cfg.name, n_layers=cfg.n_layers,
                        first_k_dense=cfg.first_k_dense,
                        n_experts=cfg.n_experts, moe_top_k=cfg.moe_top_k,
                        mtp_depth=cfg.mtp_depth,
                        params=model.count_params(cfg)))
    return out


def _train_card_vs_cpu(arch: str = TRAIN_ARCH, cut=None,
                       limits=TRAIN_GRAD_LIMITS, repeat: bool = False):
    """`_train_step_grads` at its default seeds and `cut` (TRAIN_CPU_LAYERS
    deep where none is given), held to the CPU: loss and
    lr (and an MoE arch's aux loss, deepseek-v3's MTP cross-entropy)
    within 1e-5 relative, the same routing
    as the CPU's (top-k indices and kept assignments; the f64 oracle's
    differences are reported), with `repeat` a second card gradient
    equal to the first bit for bit, and the updated parameters within 2 lr
    + 1e-6,
    the CPU tests' tolerances (f32 sums in other orders; AdamW's first
    step turns a gradient near 0 into +-lr).  Each tensor's gradient is
    within its limit in `limits` (TRAIN_GRAD_LIMITS for starcoder2,
    ZAMBA_GRAD_LIMITS for zamba2, RWKV_GRAD_LIMITS for rwkv6,
    PHI3_GRAD_LIMITS and MUSICGEN_GRAD_LIMITS for the embedding-input
    archs, DBRX_GRAD_LIMITS and DEEPSEEK_GRAD_LIMITS for the MoE archs) of
    the CPU's, the TF32 control must
    read more than that limit on every tensor, and the gradient norm is
    held to the bound those limits give it (|‖a‖ − ‖b‖| <= ‖a − b‖).  A
    tensor the loss does not reach (the embedding table of an
    embedding-input arch: zero on the CPU) must read zero on the card and
    has no control.  The log line and the record give the host's seconds
    by stage (`host_s`: `_train_step_grads`)."""
    import re
    r = _train_step_grads(arch=arch, cut=cut, repeat=repeat)
    met, per, routing = r["metrics"], r["tensors"], r["routing"]
    rel = {k: abs(met["card"][k] - met["cpu"][k]) / abs(met["cpu"][k])
           for k in ("loss", "grad_norm", "lr")
           + (("aux",) if routing["moe_layers"] else ())
           + (("mtp_ce",) if "mtp_ce" in met["cpu"] else ())}
    # for a zero CPU gradient, card_cpu is the card gradient's norm
    unreached = {k for k, t in per.items() if t["norm"] == 0.0}
    lim = {k: 0.0 if k in unreached
           else next(v for pat, v in limits if re.fullmatch(pat, k))
           for k in per}
    over = {k: t["card_cpu"] for k, t in per.items()
            if not t["card_cpu"] <= lim[k]}
    blind = {k: t["tf32_cpu"] for k, t in per.items()
             if k not in unreached and not t["tf32_cpu"] > lim[k]}
    norm_tol = math.sqrt(sum((lim[k] * t["norm"]) ** 2 for k, t in
                             per.items())) / met["cpu"]["grad_norm"]
    lr = met["cpu"]["lr"]
    err = r["max_param_err"]
    routed = routing["card_cpu"] == dict(idx=0, keep=0)
    repeated = r.get("repeat_bitwise", True)
    if over or blind or not (rel["loss"] <= 1e-5 and rel["lr"] <= 1e-5
                             and rel.get("aux", 0.0) <= 1e-5
                             and rel.get("mtp_ce", 0.0) <= 1e-5
                             and rel["grad_norm"] <= norm_tol
                             and err <= 2 * lr + 1e-6
                             and routed and repeated):
        raise AssertionError(
            f"train card vs CPU ({arch}): {rel} (grad norm tol {norm_tol}); tensors "
            f"over their limit {over}; tensors the TF32 control passes "
            f"{blind}; parameters {err} > {2 * lr + 1e-6}; routing "
            f"{routing}; repeat bitwise {repeated}")
    by_limit = {}
    for k, v in lim.items():
        by_limit.setdefault(v, []).append(k)
    c = r["cut"]
    moe_kw = {} if not routing["moe_layers"] else dict(
        first_k_dense=c["first_k_dense"], experts=c["n_experts"],
        top_k=c["moe_top_k"], assignments=routing["assignments"],
        dropped_cpu=routing["dropped_cpu"],
        routing_diff_card_cpu=routing["card_cpu"],
        routing_diff_f64_cpu=routing["f64_cpu"],
        routing_diff_tf32_cpu=routing["tf32_cpu"])
    if repeat:
        moe_kw["repeat_bitwise"] = repeated
    if c["mtp_depth"]:
        moe_kw.update(mtp_depth=c["mtp_depth"],
                      mtp_ce=f"{met['card']['mtp_ce']:.6f}")
    log("train.card_vs_cpu", arch=arch, layers=c["n_layers"],
        params=c["params"], dtype="float32",
        **moe_kw, loss=f"{met['card']['loss']:.6f}",
        **{f"{k}_rel": f"{v:.3g}" for k, v in rel.items()},
        grad_norm_tol=f"{norm_tol:.3g}",
        **{f"limit_{v:g}": f"max {max(per[k]['card_cpu'] for k in ks):.3g}"
                           f" tf32_min {min(per[k]['tf32_cpu'] for k in ks):.3g}"
           for v, ks in by_limit.items() if v > 0},
        unreached=sorted(unreached),
        max_param_err=f"{err:.3g}", param_tol=f"{2 * lr + 1e-6:.3g}",
        **{f"host_{k}_s": f"{v:.2f}" for k, v in r["host_s"].items()},
        host_mem_available_gib=f"{r['host_mem_available_gib']:.1f}",
        host_peak_rss_gib=f"{r['host_peak_rss_gib']:.1f}")
    return dict(arch=arch, cut=c, layers=c["n_layers"],
                experts=c["n_experts"], metrics=met,
                rel=rel, routing=routing, repeat_bitwise=r.get(
                    "repeat_bitwise"), host_s=r["host_s"],
                host_mem_available_gib=r["host_mem_available_gib"],
                host_peak_rss_gib=r["host_peak_rss_gib"],
                grad_norm_tol=norm_tol, tensors=per, limits=lim,
                unreached=sorted(unreached),
                max_param_err=err, param_tol=2 * lr + 1e-6)


def phase_train():
    """Training through the port: starcoder2-3b's full-depth run with its
    launch counts, the checkpoint round trip and resume at a depth cut,
    and one step on the card against the CPU; then zamba2-2.7b's
    full-depth run (its SSD's gradient through the backward kernel) and
    its one-group step on the card against the CPU; then rwkv6-3b's
    full-depth run (its WKV's gradient through the backward kernel) and
    its 2-layer step on the card against the CPU; then phi-3-vision-4.2b's
    and musicgen-large's full-depth runs on embeddings (musicgen at
    accum_steps 2) and their 2-layer steps on the card against the CPU;
    then dbrx-132b at published widths, 1 layer deep, at accum_steps 1,
    and its 1-layer step with 8 of its 16 experts on the card against the
    CPU (DBRX_TRAIN_ARCH: why it is cut); then deepseek-v3-671b at
    published widths with its MTP loss, 4 layers deep (3 dense), 32 of its
    256 experts, at accum_steps 1, and its 1-layer step (the MoE layer
    and the MTP block) with 16 experts on the card against the CPU
    (DEEPSEEK_TRAIN_ARCH: why it is cut).
    No checkpoint round for the others: the format is the model's tree,
    which starcoder2 proves."""
    import torch
    # a trainer runs in a process of its own: the serve phases' cached
    # blocks are handed back first, so they do not shape its allocations
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out, launches = _train_full_depth(TRAIN_ARCH)
    out["full_depth_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["checkpoint"] = _train_checkpoint_resume()
    out["checkpoint_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["card_vs_cpu"] = _train_card_vs_cpu()
    out["card_vs_cpu_s"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    zamba, zamba_launches = _train_full_depth(ZAMBA_TRAIN_ARCH)
    zamba["full_depth_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    zamba["card_vs_cpu"] = _train_card_vs_cpu(
        ZAMBA_TRAIN_ARCH, dict(n_layers=ZAMBA_CPU_LAYERS), ZAMBA_GRAD_LIMITS)
    zamba["card_vs_cpu_s"] = time.perf_counter() - t1
    out["zamba2"] = zamba
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rwkv, rwkv_launches = _train_full_depth(RWKV_TRAIN_ARCH)
    rwkv["full_depth_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rwkv["card_vs_cpu"] = _train_card_vs_cpu(
        RWKV_TRAIN_ARCH, dict(n_layers=RWKV_CPU_LAYERS), RWKV_GRAD_LIMITS)
    rwkv["card_vs_cpu_s"] = time.perf_counter() - t1
    out["rwkv6"] = rwkv
    per_arch = [zamba_launches, rwkv_launches]
    for arch, limits in ((PHI3_TRAIN_ARCH, PHI3_GRAD_LIMITS),
                         (MUSICGEN_TRAIN_ARCH, MUSICGEN_GRAD_LIMITS)):
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res, arch_launches = _train_full_depth(arch)
        res["full_depth_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        res["card_vs_cpu"] = _train_card_vs_cpu(arch, limits=limits)
        res["card_vs_cpu_s"] = time.perf_counter() - t1
        out[arch] = res
        per_arch.append(arch_launches)
    for arch, cut, cpu_cut, limits in (
            (DBRX_TRAIN_ARCH, DBRX_TRAIN_CUT, DBRX_CPU_CUT, DBRX_GRAD_LIMITS),
            (DEEPSEEK_TRAIN_ARCH, DEEPSEEK_TRAIN_CUT, DEEPSEEK_CPU_CUT,
             DEEPSEEK_GRAD_LIMITS)):
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res, arch_launches = _train_full_depth(_depth_cut(arch, **cut),
                                               accum_steps=1)
        res["full_depth_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res["card_vs_cpu"] = _train_card_vs_cpu(arch, cpu_cut, limits,
                                                repeat=True)
        res["card_vs_cpu_s"] = time.perf_counter() - t1
        out[arch] = res
        per_arch.append(arch_launches)
    launches = {k: launches[k] + sum(p[k] for p in per_arch)
                for k in launches}
    out["seconds"] = time.perf_counter() - t0
    log("train.total", seconds=f"{out['seconds']:.3f}",
        full_depth_s=f"{out['full_depth_s']:.3f}",
        checkpoint_s=f"{out['checkpoint_s']:.3f}",
        card_vs_cpu_s=f"{out['card_vs_cpu_s']:.3f}",
        zamba2_full_depth_s=f"{zamba['full_depth_s']:.3f}",
        zamba2_card_vs_cpu_s=f"{zamba['card_vs_cpu_s']:.3f}",
        rwkv6_full_depth_s=f"{rwkv['full_depth_s']:.3f}",
        rwkv6_card_vs_cpu_s=f"{rwkv['card_vs_cpu_s']:.3f}",
        **{f"{arch}_{k}": f"{out[arch][k]:.3f}"
           for arch in (PHI3_TRAIN_ARCH, MUSICGEN_TRAIN_ARCH,
                        DBRX_TRAIN_ARCH, DEEPSEEK_TRAIN_ARCH)
           for k in ("full_depth_s", "card_vs_cpu_s")}, **launches)
    return out, launches


def _twins_at(rec: dict) -> int:
    """Hold the backward kernels' Python twins (`splits_rule`,
    `scratch_floats`), which a dry run uses on meta, to the library's C
    functions at every operand shape a dry-run record `rec` gave the
    backward kernels; returns the shapes checked."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv

    def calls(name):
        return [c["operands"]
                for c in rec["kernels"].get(name, {}).get("operands", [])]

    n = 0
    for (qs, t), (ks, _), (vs, _) in calls("flash_attention_bwd"):
        b, sq, h, dh = qs
        skv, hkv, dv = ks[1], ks[2], vs[3]
        dtype = getattr(torch, t)
        lib = fa.load()
        _twin_agrees(f"flash_attention_bwd {qs} {ks} {vs} {t}",
                     (lib.flash_attention_bwd_splits(b, skv, h, hkv, dh, dv,
                                                     fa.DTYPES[dtype]),
                      lib.flash_attention_bwd_scratch(b, sq, skv, h, hkv, dh,
                                                      dv, fa.DTYPES[dtype])),
                     (fa.splits_rule(b, skv, h, hkv, dh, dv, dtype),
                      fa.scratch_floats(b, sq, skv, h, hkv, dh, dv, dtype)))
        n += 1
    for (xs, _), (bs, _) in calls("mamba2_ssd_bwd"):
        _twin_agrees(f"mamba2_ssd_bwd {xs} {bs}",
                     ssd.bwd_scratch(*xs, bs[2]),
                     ssd.scratch_floats(*xs, bs[2]))
        n += 1
    for (rs, _), (vs, _) in calls("rwkv6_wkv_bwd"):
        _twin_agrees(f"rwkv6_wkv_bwd {rs} {vs}",
                     wkv.bwd_scratch(*rs, vs[3]),
                     wkv.scratch_floats(*rs, vs[3]))
        n += 1
    return n


def phase_cost(train_out):
    """The dry run of each train run (COST_RUNS) on meta tensors, held to
    what the run measured on the card: the kernels' calls to its launch
    counts, its median step to the roofline, its peak device memory to
    the predicted peak; then each roofline installed as a runtime prior
    through calibrate(priors=...) and read back."""
    from repro_torch import configs
    from repro_torch.core import backends
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.launch import cost, dryrun
    from repro_torch.models.config import ShapeConfig
    from repro_torch.obs.calib import calibrate, hlo_runtime_prior
    shape = ShapeConfig(f"train_b{TRAIN_BATCH}_s{TRAIN_SEQ}", TRAIN_SEQ,
                        TRAIN_BATCH, "train")
    before = {**fa.launches, **ssd.launches, **wkv.launches}
    out, priors = {}, {}
    for arch, key, cut in COST_RUNS:
        res = train_out if key is None else train_out[key]
        overrides = dict(cut, accum_steps=res["accum_steps"])
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, overrides=overrides,
                              tag="chip_smoke", save=False, verbose=False)
        dry_s = time.perf_counter() - t0
        if rec["status"] != "ok":
            raise AssertionError(f"cost {arch}: the dry run gave {rec}")
        predicted = {name: rec["kernels"].get(name, {}).get("calls", 0)
                     * TRAIN_STEPS for name in res["launches"]}
        want = _train_launches_want(configs.get(arch).replace(**overrides))
        if not predicted == res["launches"] == want:
            raise AssertionError(
                f"cost {arch}: the dry run's kernel calls x {TRAIN_STEPS} "
                f"steps {predicted}, the run's launches {res['launches']}, "
                f"_train_launches_want {want}")
        step_s = res["step_ms_median_last4"] / 1e3
        roof = rec["roofline"]
        if not step_s >= roof["roofline_s"]:
            raise AssertionError(
                f"cost {arch}: the card's step {step_s} s beats the "
                f"roofline {roof['roofline_s']} s: a miscount")
        peak_gib = rec["peak_bytes"] / 2 ** 30
        peak_rel = peak_gib / res["peak_device_gib"] - 1
        if not abs(peak_rel) <= COST_PEAK_TOL:
            raise AssertionError(
                f"cost {arch}: predicted peak {peak_gib} GiB, measured "
                f"{res['peak_device_gib']} GiB")
        twins = _twins_at(rec)
        priors[arch] = hlo_runtime_prior(
            cost.op_cost(rec), peak_flops=cost.prior_peak_flops(rec),
            mem_bw=cost.HBM_BYTES_PER_S)
        out[arch] = dict(
            overrides=overrides, dry_run_s=dry_s,
            kernel_calls_per_step={k: v["calls"]
                                   for k, v in rec["kernels"].items()},
            flops=rec["flops"], flops_by_type=rec["flops_by_type"],
            bytes=rec["bytes"], model_flops=rec["model_flops"],
            useful_flops_ratio=rec["useful_flops_ratio"],
            roofline=roof, step_s=step_s,
            step_over_roofline=step_s / roof["roofline_s"],
            step_over_op_sum=step_s / roof["op_sum_s"],
            predicted_peak_gib=peak_gib,
            measured_peak_gib=res["peak_device_gib"],
            predicted_over_measured_peak=peak_gib / res["peak_device_gib"],
            argument_gib=rec["argument_bytes"] / 2 ** 30,
            twin_shapes_checked=twins, prior_s=priors[arch])
        log(f"cost.{arch}", dry_run_s=f"{dry_s:.2f}",
            calls=out[arch]["kernel_calls_per_step"],
            step_ms=f"{step_s * 1e3:.2f}",
            roofline_ms=f"{roof['roofline_s'] * 1e3:.3f}",
            dominant=roof["dominant"],
            compute_ms=f"{roof['compute_s'] * 1e3:.3f}",
            memory_ms=f"{roof['memory_s'] * 1e3:.3f}",
            op_sum_ms=f"{roof['op_sum_s'] * 1e3:.3f}",
            step_over_roofline=f"{out[arch]['step_over_roofline']:.4f}",
            step_over_op_sum=f"{out[arch]['step_over_op_sum']:.4f}",
            predicted_peak_gib=f"{peak_gib:.3f}",
            measured_peak_gib=f"{res['peak_device_gib']:.3f}",
            peak_rel=f"{peak_rel:+.4f}", twin_shapes=twins,
            prior_s=f"{priors[arch]:.6f}")
    spec = calibrate([], backends.get("hq"), priors=priors)
    for arch, prior in priors.items():
        fit = spec.runtime_fit(arch)
        if fit is None or fit.source != "prior" or fit.median != prior:
            raise AssertionError(f"cost {arch}: calibrate installed {fit}, "
                                 f"not the prior {prior} s")
    if {**fa.launches, **ssd.launches, **wkv.launches} != before:
        raise AssertionError("cost: a dry run launched a kernel")
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
    request (a 512-token prefill alone, then prefill + 16 new tokens) on
    a warm full-width server, with the operators that take the device
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
    def window(name, fn, with_ops=True):
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
        top = _top_device_ops(prof) if with_ops else []
        out[name] = dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                         device_idle_share=idle, top_device_ops=top)
        log("where", window=name, wall_ms=f"{wall * 1e3:.3f}",
            device_busy_ms=busy if busy is not None else "not measured",
            idle_share=idle if idle is not None else "not measured")
        for op, ms, calls in top:
            log("where.op", window=name, op=repr(op), device_ms=f"{ms:.3f}",
                calls=calls)

    window("solve", lambda: gs2_proxy.solve(theta), with_ops=False)
    window("recost_10k", lambda: pred.predict_many_with_sd(reqs),
           with_ops=False)
    window("serve_prefill_512", lambda: srv.generate(prompt, 1))
    window("serve_request_512+16", lambda: srv.generate(prompt,
                                                        SERVE_MAX_NEW))
    window("rwkv_prefill_512", lambda: rwkv.generate(rwkv_prompt, 1))
    window("rwkv_request_512+16", lambda: rwkv.generate(rwkv_prompt,
                                                        SERVE_MAX_NEW))
    log("where", window="solve_alone", iters=iters,
        us_per_iter=f"{out['us_per_iter']:.2f}")
    return out


# ---------------------------------------------------------------------------
def main() -> int:
    t_script = time.perf_counter()
    phase_s = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        phase_s[label] = time.perf_counter() - t0
        log("phase", name=label, seconds=f"{phase_s[label]:.3f}")
        return res

    name, smi = timed("device", phase_device)
    build_s = timed("build", phase_build)
    rows = (timed("kernels", phase_kernels)
            + timed("lm_kernels", phase_lm_kernels))
    main_out, main_launches, post, backlog, gp_state = timed("main",
                                                             phase_main)
    sim_out, sim_launches = timed("sim", phase_sim, post, backlog)
    service_out, service_launches = timed("service", phase_service,
                                          gp_state, backlog)
    serve_out, serve_launches = timed("serve", phase_serve, SERVE_ARCH,
                                      ("mamba2_ssd", "flash_attention"))
    rwkv_out, rwkv_launches = timed("serve_rwkv", phase_serve, RWKV_ARCH,
                                    ("rwkv6_wkv",))
    dense_out, dense_launches = {}, {}
    for arch in DENSE_ARCHS:
        dense_out[arch], dense_launches[arch] = timed(
            f"serve_{arch}", phase_serve, arch, ("flash_attention",))
    moe_out, moe_launches = {}, {}
    for arch in MOE_ARCHS:
        moe_out[arch], moe_launches[arch] = timed(
            f"serve_{arch}", phase_serve,
            _depth_cut(arch, n_layers=MOE_SERVE_LAYERS),
            ("flash_attention",))
    serve_check = timed("serve_check", phase_serve_check)
    train_out, train_launches = timed("train", phase_train)
    cost_out = timed("cost", phase_cost, train_out)
    where = timed("where", phase_where)
    # each path's launches, counted from zero on that path
    by_path = {"main": main_launches, "sim": sim_launches,
               "service": service_launches, "serve": serve_launches,
               "serve_rwkv": rwkv_launches,
               **{f"serve_{arch}": per
                  for arch, per in dense_launches.items()},
               **{f"serve_{arch}": per
                  for arch, per in moe_launches.items()},
               "train": train_launches}
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
                "flash_attention_bwd": "src/repro/kernels/ref.py:142 "
                                       "(_flash_bwd, custom VJP; no Pallas "
                                       "kernel)",
                "mamba2_ssd": "src/repro/kernels/mamba2_ssd.py:24",
                "mamba2_ssd_bwd": "src/repro/kernels/ref.py:310 "
                                  "(XLA's autodiff of mamba2_ssd_chunked; "
                                  "no Pallas kernel)",
                "rwkv6_wkv": "src/repro/kernels/rwkv6_scan.py:24",
                "rwkv6_wkv_bwd": "src/repro/kernels/ops.py:55 (XLA's "
                                 "autodiff of rwkv6_wkv; no Pallas kernel)"}
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
                                 "phase_ms", "launch_floor_ms", "note",
                                 "max_abs_err_f64",
                                 "grad_tol", "max_rel_err",
                                 "rel_err_by_grad", "blocks_per_sm",
                                 "rel_to_scan", "library_kernels")
               if k in r}))
    script_s = time.perf_counter() - t_script
    log("total", seconds=f"{script_s:.1f}")
    record = dict(device=name, nvidia_smi=smi, build_s=build_s,
                  script_s=script_s, phase_s=phase_s,
                  kernels=kernels, launches=launches,
                  launches_by_path=by_path, main=main_out, sim=sim_out,
                  service=service_out, serve=serve_out, serve_rwkv=rwkv_out,
                  serve_dense=dense_out, serve_moe=moe_out,
                  bwd_splits={r["name"]: r["splits"] for r in rows
                              if "splits" in r},
                  serve_check=serve_check, train=train_out, cost=cost_out,
                  where=where,
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
