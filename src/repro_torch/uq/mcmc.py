"""Metropolis-Hastings over the forward model, scheduled as a DEPENDENT
task chain (paper §II-C: "MCMC methods require a well-defined dependency
structure ... each step depends on the results of the previous").

Each proposal evaluation is an `EvalRequest` whose `depends_on` points at
the previous accepted state's evaluation — the executor releases it only
when its predecessor completes, so the chain structure lives in the
scheduler, not in client-side blocking.  Multiple independent chains
interleave freely across the worker pool (the standard multi-chain UQ
pattern the HQ backend is built for).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.executor import Executor
from repro_torch.core.task import EvalRequest


@dataclasses.dataclass
class MCMCResult:
    samples: np.ndarray              # [n_kept, d]
    log_likelihoods: np.ndarray      # [n_kept]
    accept_rate: float
    n_evals: int


def gaussian_loglike(output: Sequence[float], observed: Sequence[float],
                     sigma: float = 0.1) -> float:
    out = np.asarray(output, float)
    obs = np.asarray(observed, float)
    return float(-0.5 * np.sum((out - obs) ** 2) / sigma ** 2)


def run_chain(executor: Executor, model_name: str, *,
              x0: np.ndarray, bounds: Sequence[Tuple[float, float]],
              observed: Sequence[float], n_steps: int = 50,
              step_scale: float = 0.1, sigma: float = 0.1,
              seed: int = 0, timeout: float = 600.0) -> MCMCResult:
    """One MH chain; evaluations flow through the scheduler with explicit
    dependency edges."""
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    scale = step_scale * (hi - lo)

    def propose(x):
        return np.clip(x + rng.normal(size=x.shape) * scale, lo, hi)

    # initial evaluation
    req = EvalRequest(model_name, [list(map(float, x0))])
    executor.submit(req)
    res = executor.result(req.task_id, timeout)
    if res.status != "ok":
        raise RuntimeError(f"initial evaluation failed: {res.error}")
    x, ll = np.asarray(x0, float), gaussian_loglike(res.value[0], observed,
                                                    sigma)
    prev_task = req.task_id

    samples, lls = [x.copy()], [ll]
    accepts, n_evals = 0, 1
    for _ in range(n_steps):
        xp = propose(x)
        req = EvalRequest(model_name, [xp.tolist()],
                          depends_on=(prev_task,))
        executor.submit(req)
        res = executor.result(req.task_id, timeout)
        n_evals += 1
        if res.status == "ok":
            llp = gaussian_loglike(res.value[0], observed, sigma)
            if math.log(max(rng.random(), 1e-300)) < llp - ll:
                x, ll = xp, llp
                accepts += 1
                prev_task = req.task_id
        samples.append(x.copy())
        lls.append(ll)
    return MCMCResult(samples=np.asarray(samples),
                      log_likelihoods=np.asarray(lls),
                      accept_rate=accepts / max(n_steps, 1),
                      n_evals=n_evals)


def run_chains(executor: Executor, model_name: str, *,
               x0s: Sequence[np.ndarray], **kw) -> List[MCMCResult]:
    """Multiple chains; their dependent requests interleave across the
    pool (chains are independent; steps within a chain are ordered)."""
    import threading
    out: List[Optional[MCMCResult]] = [None] * len(x0s)

    def _one(i):
        out[i] = run_chain(executor, model_name, x0=x0s[i],
                           seed=kw.pop("seed", 0) + i if "seed" in kw
                           else i, **{k: v for k, v in kw.items()
                                      if k != "seed"})

    threads = [threading.Thread(target=_one, args=(i,))
               for i in range(len(x0s))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return list(out)  # type: ignore[return-value]
