"""Quickstart on the PyTorch port (twin of examples/quickstart.py):
UM-Bridge-style models behind the HQ load balancer.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

Registers two forward models (an eigenproblem and a GP surrogate), runs a
batch of evaluation requests through the persistent-worker load balancer,
and prints the scheduling metrics the paper is about.  The GP runs on the
card by default; `--device cpu` runs it on the CPU.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np

from repro_torch import device
from repro_torch.core import EvalRequest, LambdaModel, LoadBalancer, metrics
from repro_torch.uq import gp as gp_lib
from repro_torch.uq import sampling
from repro_torch.uq.eigen import EigenModel


def gp_model_factory():
    """A small GP surrogate of the GS2 growth rate (trained on synthetic
    observations here; examples/uq_gs2_workflow_torch.py trains on the
    real proxy)."""
    thetas = sampling.latin_hypercube(32, seed=0)
    y = np.sin(thetas[:, 6] * 3) * thetas[:, 3] * 0.1
    post = gp_lib.fit(thetas, y, steps=60)

    def fn(parameters, config):
        mean, var = gp_lib.predict(post, np.asarray(parameters, np.float32))
        return [[float(mean[0, 0]), float(var[0, 0])]]

    return LambdaModel("gp-surrogate", fn, 7, 2,
                       warmup_fn=lambda: fn([thetas[0].tolist()], None))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the GP runs: cuda (default) or cpu")
    args = ap.parse_args()
    device.set_device(args.device)
    device.get()                               # no card -> raise here

    with LoadBalancer(backend="hq", n_workers=4) as lb:
        lb.register_model("eigen-100", lambda: EigenModel(100))
        lb.register_model("gp-surrogate", gp_model_factory)
        print("registered models:",
              {k: (v.input_sizes, v.output_sizes)
               for k, v in lb.models().items()})

        # one-off synchronous call (the umbridge client pattern)
        out = lb.evaluate("eigen-100", [[0]])
        print(f"eigen-100([[0]]) -> spectral abscissa {out[0][0]:.4f}")

        # a batch of mixed-cost requests, first-come-first-served
        thetas = sampling.latin_hypercube(16, seed=1)
        reqs = [EvalRequest("gp-surrogate", [t.tolist()]) for t in thetas]
        reqs += [EvalRequest("eigen-100", [[0]]) for _ in range(8)]
        t0 = time.monotonic()
        results = lb.run_all(reqs, timeout=300)
        wall = time.monotonic() - t0

        ok = sum(r.status == "ok" for r in results)
        summary = metrics.summarize("quickstart", "hq", lb.records())
        print(f"\n{ok}/{len(results)} evaluations ok in {wall:.2f}s wall "
              f"on {args.device}")
        print(f"total cpu  : {summary.total_cpu_time:.2f}s")
        print(f"overhead   : {summary.scheduling_overhead:.3f}s "
              f"(median/task {summary.overhead_stats['median'] * 1e3:.1f}ms)")
        print(f"SLR        : {summary.slr:.2f}")


if __name__ == "__main__":
    main()
