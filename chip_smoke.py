#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, and hold each of
its hand-written kernels against its plain PyTorch version.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one line each; any failure exits non-zero, and nothing falls back
to the CPU:

  1. device   — a CUDA card is required; its name and power limit.
  2. build    — compile the GP kernels from src/repro_torch/kernels/csrc
                into build/repro_torch/ and load them.
  3. kernels  — each kernel against its plain version at the main path's
                shapes, with its device time (torch.profiler), its time per
                back-to-back call (CUDA events), the plain version's device
                time and the least time the card could take (bound).
  4. main     — the paper's loop through the port's entry points: 256 GS2
                solves on the Executor (8 persistent workers, GP runtime
                predictor), one naive fresh-server pass, a GP fit, a
                100,000-task backlog re-costed through PackingPolicy and
                trust-scored through SurrogateOffload, a partitioned engine
                at n=8,192 predicting the same backlog, and QoI quadrature.
                The kernels' launch counters are zeroed just before and
                must all have risen just after.  The card's predictions are
                held against the port on the CPU for the same posterior.
  5. where    — outside the counted run: one GS2 solve alone, and the
                device's busy share (torch.profiler) during a solve and a
                10,000-task re-cost.

Before the last line it prints one JSON object with every kernel's
numbers; the last line is {"ok": true, "device": {...}}.  The full record
is also written to chiprun_out/chip_smoke.json.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): HBM rate and f32 FLOP/s
# outside the tensor cores — the kernels run IEEE f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

N_SIMS = 256
N_WORKERS = 8
N_NAIVE = 32
N_BACKLOG = 100_000
N_PARTITIONED = 8_192
FIT_STEPS = 150


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


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time per call of `fn`: the summed time of every kernel
    it launched (torch.profiler), over `iters` calls.  Back-to-back event
    timing of a tens-of-microseconds kernel measures the wrapper's host
    work instead, so this is the kernel's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = _device_busy_ms(prof)
    if busy <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return busy / iters


def _device_busy_ms(prof) -> float:
    """Sum of device time over the kernels a profiler window recorded."""
    total = 0.0
    for evt in prof.key_averages():
        total += getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
    return total / 1e3


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
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
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the GP path is f32")
    name = torch.cuda.get_device_name(0)
    log("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def phase_build():
    from repro_torch.kernels import gp_kernel
    t0 = time.perf_counter()
    gp_kernel.load()
    seconds = time.perf_counter() - t0
    regs = [ln.strip() for ln in str(gp_kernel.build_info["log"]).splitlines()
            if "registers" in ln]
    log("build", seconds=f"{seconds:.2f}", library=gp_kernel.build_info["path"],
        ptxas=regs)
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

    # gp_kernel_matrix: K(X, X) of a 2,048-point GS2 training set
    n = 2048
    x = randn(n, d)
    ls = torch.exp(0.2 * randn(d))
    var = torch.tensor(1.7, device=dev)
    for kind in ("rbf", "matern52"):
        got = gp_kernel.gp_kernel_matrix(x, x, ls, var, kind)
        torch.cuda.synchronize()
        want = ref.gp_kernel_matrix(x, x, ls, var, kind)
        err = max_err(got, want)
        if not err <= 2e-5:
            raise AssertionError(f"gp_kernel_matrix {kind}: {err} > 2e-5")
        run = (lambda: gp_kernel.gp_kernel_matrix(x, x, ls, var, kind))
        ms, call = device_ms(run, 200), call_ms(run, 200)
        plain = device_ms(lambda: ref.gp_kernel_matrix(x, x, ls, var,
                                                       kind), 200)
        per_elem = 2 * d + 6 + (8 if kind == "matern52" else 2)
        b, by = bound_ms(4 * (2 * n * d + d + 1) + 4 * n * n,
                         n * n * per_elem + 2 * n * 2 * d)
        rows.append(dict(name=f"gp_kernel_matrix[{kind}]", shape=f"{n}x{n}x{d}",
                         max_abs_err=err, tol=2e-5, ms=ms, call_ms=call,
                         plain_ms=plain, bound_ms=b, bound_by=by))

    # gp_predict: the predictor's 256-point posterior and a 2,048-point
    # one, against the top bucket (1,024 queries), two outputs
    s, m = 1024, 2
    for n in (256, 2048):
        xt, xs = randn(n, d), randn(s, d)
        ls = 2.0 * torch.exp(0.2 * randn(d))
        var = torch.tensor(1.3, device=dev)
        linv = _linv(ref.gp_kernel_matrix(xt, xt, ls, var))
        alpha = randn(n, m)
        args = (xt, xs, ls, var, alpha, linv)
        got = gp_kernel.gp_predict(*args)
        torch.cuda.synchronize()
        want = ref.gp_predict(*args)
        err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        if not err <= 1e-4:
            raise AssertionError(f"gp_predict n={n}: {err} > 1e-4")
        ms = device_ms(lambda: gp_kernel.gp_predict(*args), 50)
        call = call_ms(lambda: gp_kernel.gp_predict(*args), 50)
        plain = device_ms(lambda: ref.gp_predict(*args), 50)
        tri = n * (n + 1) // 2
        b, by = bound_ms(4 * (n * d + s * d + d + 1 + n * m + tri + s * m + s),
                         s * (2 * tri + n * (2 * d + 2 * m + 8)))
        rows.append(dict(name=f"gp_predict[n={n}]", shape=f"n{n} s{s} m{m}",
                         max_abs_err=err, tol=1e-4, ms=ms, call_ms=call,
                         plain_ms=plain, bound_ms=b, bound_by=by))

    # gp_predict_experts: 64 experts of expert_cap=128, 1,024 queries each
    e, n, s, m = 64, 128, 1024, 1
    xt, xs = randn(e, n, d), randn(e, s, d)
    ls = 2.0 * torch.exp(0.2 * randn(d))
    var = torch.tensor(1.3, device=dev)
    linv = _linv(ref.gp_kernel_matrix(xt, xt, ls, var))
    alpha = randn(e, n, m)
    args = (xt, xs, ls, var, alpha, linv)
    got = gp_kernel.gp_predict_experts(*args)
    torch.cuda.synchronize()
    want = ref.gp_predict_experts(*args)
    err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
    if not err <= 1e-4:
        raise AssertionError(f"gp_predict_experts: {err} > 1e-4")
    ms = device_ms(lambda: gp_kernel.gp_predict_experts(*args), 50)
    call = call_ms(lambda: gp_kernel.gp_predict_experts(*args), 50)
    plain = device_ms(lambda: ref.gp_predict_experts(*args), 50)
    tri = n * (n + 1) // 2
    b, by = bound_ms(4 * e * (n * d + s * d + n * m + tri + s * m + s)
                     + 4 * (d + 1),
                     e * s * (2 * tri + n * (2 * d + 2 * m + 8)))
    rows.append(dict(name="gp_predict_experts", shape=f"e{e} n{n} s{s} m{m}",
                     max_abs_err=err, tol=1e-4, ms=ms, call_ms=call,
                     plain_ms=plain, bound_ms=b, bound_by=by))
    for r in rows:
        log("kernel", **{k: (f"{v:.6g}" if isinstance(v, float) else v)
                         for k, v in r.items()})
    return rows, src


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
    return out, launches


def phase_where():
    """Where the main path's time goes, outside the counted run: one GS2
    solve alone on one thread, and the device's busy share (profiler)
    during a solve and during a 10,000-task re-cost."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import EvalRequest
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
    for name, fn in (("solve", lambda: gs2_proxy.solve(theta)),
                     ("recost_10k", lambda: pred.predict_many_with_sd(reqs))):
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
        out[name] = dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                         device_idle_share=idle)
        log("where", window=name, wall_ms=f"{wall * 1e3:.3f}",
            device_busy_ms=busy if busy is not None else "not measured",
            idle_share=idle if idle is not None else "not measured")
    log("where", window="solve_alone", iters=iters,
        us_per_iter=f"{out['us_per_iter']:.2f}")
    return out


# ---------------------------------------------------------------------------
def main() -> int:
    name, smi = phase_device()
    build_s = phase_build()
    rows, src = phase_kernels()
    main_out, launches = phase_main()
    where = phase_where()

    replaces = {"gp_kernel_matrix": "src/repro/kernels/gp_kernel.py:23",
                "gp_predict": "src/repro/kernels/gp_kernel.py:79",
                "gp_predict_experts": "src/repro/kernels/gp_kernel.py:159"}
    kernels = []
    for r in rows:
        base = r["name"].split("[")[0]
        kernels.append(dict(
            name=r["name"], route="cuda", source=src,
            replaces=replaces[base], launches=launches[base],
            max_abs_err=r["max_abs_err"], ms=r["ms"], call_ms=r["call_ms"],
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    record = dict(device=name, nvidia_smi=smi, build_s=build_s,
                  kernels=kernels, main=main_out, where=where)
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
