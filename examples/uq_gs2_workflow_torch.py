"""End-to-end UQ workflow on the PyTorch port (twin of
examples/uq_gs2_workflow.py).

    PYTHONPATH=src python examples/uq_gs2_workflow_torch.py [--n-sims 24]
        [--device cuda|cpu]

Pipeline (all scheduled through the persistent-worker executor):
  1. Latin-hypercube sample the 7 GS2 inputs (Table II ranges).
  2. Run the GS2-proxy linear-stability solves as load-balanced tasks;
     compare persistent workers with a fresh server per task.
  3. Train the GP surrogate (growth rate, frequency) on the results.
  4. Compute the quasilinear QoI integral (eq. 5) by direct quadrature on
     the surrogate and by adaptive Bayesian quadrature.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np

from repro_torch import device
from repro_torch.core import EvalRequest, Executor, LambdaModel, metrics
from repro_torch.uq import gp as gp_lib
from repro_torch.uq import gs2_proxy, qoi, sampling

RESOLUTION = 48            # proxy field-line resolution


def gs2_factory():
    solver = gs2_proxy.make_solver(m=RESOLUTION)

    def fn(parameters, config):
        g, f = solver(np.asarray(parameters[0], np.float32))
        return [[g, f]]

    return LambdaModel(
        "gs2", fn, 7, 2,
        warmup_fn=lambda: solver(np.full(7, 0.5, np.float32)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-sims", type=int, default=24)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="where the port runs: cuda (default) or cpu")
    args = ap.parse_args()
    device.set_device(args.device)
    device.get()                               # no card -> raise here

    # 1. seeded LHS over Table II ranges ------------------------------
    thetas = sampling.latin_hypercube(args.n_sims, seed=11)

    # 2. schedule the simulations -------------------------------------
    print(f"== scheduling {args.n_sims} GS2-proxy solves on "
          f"{args.device} ==")
    for persistent, label in ((True, "HQ (persistent workers)"),
                              (False, "naive (fresh server per task)")):
        t0 = time.monotonic()
        with Executor({"gs2": gs2_factory}, n_workers=args.workers,
                      persistent_servers=persistent,
                      straggler_factor=6.0) as ex:
            reqs = [EvalRequest("gs2", [t.tolist()]) for t in thetas]
            results = ex.run_all(reqs, timeout=900)
            s = metrics.summarize("gs2", label, ex.records())
        wall = time.monotonic() - t0
        print(f"{label:32s} wall {wall:6.2f}s  cpu {s.total_cpu_time:6.2f}s  "
              f"init-share {1 - s.total_compute / max(s.total_cpu_time, 1e-9):.1%}")
        if persistent:
            outputs = {r.task_id: r.value[0] for r in results}
            order = [r.task_id for r in results]

    y = np.array([outputs[t] for t in order])
    print(f"\ngrowth rates: min {y[:, 0].min():.3f} max {y[:, 0].max():.3f} "
          f"({(y[:, 0] > 0).sum()}/{len(y)} unstable)")

    # 3. GP surrogate ---------------------------------------------------
    post = gp_lib.fit(thetas, y, steps=150)
    mean, _ = gp_lib.predict(post, thetas[:4])
    err = float(np.max(np.abs(mean.cpu().numpy() - y[:4])))
    print(f"GP surrogate trained: max train-point error {err:.4f}")

    # 4. QoI integral (eq. 5) ------------------------------------------
    base = thetas[0]

    def surrogate(x):
        m, _ = gp_lib.predict(post, x[None])
        m = m.cpu().numpy()
        return float(m[0, 0]), float(m[0, 1])

    t0 = time.monotonic()
    direct = qoi.quadrature(surrogate, base, n_ky=8, n_theta0=8)
    t_direct = time.monotonic() - t0
    t0 = time.monotonic()
    bq = qoi.bayesian_quadrature(surrogate, base, n_init=6, n_adaptive=8)
    t_bq = time.monotonic() - t0
    print(f"\nQoI (direct quadrature, {direct.n_evals} nodes): "
          f"{direct.value:.5f}  [{t_direct:.2f}s]")
    print(f"QoI (Bayesian quadrature, {bq.n_evals} nodes):  "
          f"{bq.value:.5f} +/- {bq.uncertainty:.5f}  [{t_bq:.2f}s]")
    print("\nworkflow complete.")


if __name__ == "__main__":
    main()
