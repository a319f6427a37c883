"""Seeded arrival traces for elasticity experiments.

The paper's benchmarks submit everything up front; elasticity only
matters when demand *varies*, so `simulate_cluster` is exercised against
arrival traces instead: tasks arrive over virtual time, and the
autoallocator must track the load without burning node-seconds through
the quiet stretches.  Everything is seeded — same seed, same trace.

  * `bursty_trace`   — bursts of near-simultaneous arrivals separated by
                       long idle gaps (campaign-style UQ usage: a user
                       fires a sweep, studies the results, fires again).
  * `bimodal_trace`  — a Poisson-ish arrival stream whose runtimes mix a
                       cheap majority with an expensive minority (the
                       GS2 "minutes to hours" spread collapsed to two
                       modes, as in `benchmarks/policy_comparison.py`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceTask:
    """One arrival: when it lands, what it costs, what model serves it."""
    t: float                         # arrival time (virtual seconds)
    runtime: float                   # true compute seconds
    model_name: str = "model"
    time_request: Optional[float] = None   # HQ-style hint (None = unknown)
    n_cpus: int = 1
    # the task's physics input theta (UM-Bridge [[...]] shape); None keeps
    # the synthetic per-index payload `simulate_cluster` generates.  Real
    # parameters are what runtime predictors and the surrogate-offload
    # trust gate discriminate on.
    parameters: Optional[List[List[float]]] = None
    # owning tenant; "default" keeps single-tenant traces unchanged
    tenant: str = "default"


def with_tenants(trace: List[TraceTask],
                 weights: "dict[str, float]") -> List[TraceTask]:
    """Assign tenants to a trace so each tenant's task *count* is
    proportional to its weight (D'Hondt divisor rounding, interleaved).

    Under exact weighted fair sharing of equal-cost tasks, tenants loaded
    proportionally to their weights all drain together — the saturating
    shape the fairness benchmarks measure shares on.  Deterministic: same
    trace + same weights -> same assignment (ties break on tenant name).
    """
    if not weights:
        return list(trace)
    names = sorted(weights)
    for t in names:
        if weights[t] <= 0:
            raise ValueError(f"tenant weight must be > 0: {t}={weights[t]}")
    counts = {t: 0 for t in names}
    out: List[TraceTask] = []
    for tt in trace:
        t = max(names, key=lambda n: (weights[n] / (counts[n] + 1), n))
        counts[t] += 1
        out.append(dataclasses.replace(tt, tenant=t))
    return out


def bursty_trace(n_bursts: int = 4, burst_size: int = 24,
                 gap_s: float = 600.0, burst_span_s: float = 10.0,
                 runtime_s: float = 20.0, jitter: float = 0.1,
                 hints: bool = True, seed: int = 0) -> List[TraceTask]:
    """`n_bursts` bursts of `burst_size` tasks each; within a burst,
    arrivals spread uniformly over `burst_span_s`; bursts start `gap_s`
    apart.  Runtimes are `runtime_s` with lognormal hardware jitter."""
    rng = np.random.default_rng(seed)
    out: List[TraceTask] = []
    for b in range(n_bursts):
        t0 = b * gap_s
        offsets = np.sort(rng.uniform(0.0, burst_span_s, size=burst_size))
        rts = runtime_s * np.exp(jitter * rng.standard_normal(burst_size))
        for off, rt in zip(offsets, rts):
            out.append(TraceTask(
                t=float(t0 + off), runtime=float(rt),
                model_name="burst-model",
                time_request=runtime_s if hints else None))
    return out


def bimodal_trace(n: int = 80, rate_per_s: float = 0.2,
                  short_s: float = 4.0, long_s: float = 60.0,
                  frac_long: float = 0.2, jitter: float = 0.05,
                  hints: bool = True, seed: int = 0) -> List[TraceTask]:
    """Exponential inter-arrivals at `rate_per_s`; a `frac_long` minority
    runs `long_s`, the rest `short_s` — two model names so per-model
    predictors and affinity routing have something to discriminate on."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_per_s, size=n))
    is_long = rng.uniform(size=n) < frac_long
    out: List[TraceTask] = []
    for t, lng in zip(arrivals, is_long):
        base = long_s if lng else short_s
        rt = base * float(np.exp(jitter * rng.standard_normal()))
        out.append(TraceTask(
            t=float(t), runtime=rt,
            model_name="long-model" if lng else "short-model",
            time_request=base if hints else None))
    return out


def trace_span(trace: List[TraceTask]) -> Tuple[float, float]:
    """(first arrival, last arrival) of a trace."""
    if not trace:
        return 0.0, 0.0
    return trace[0].t, max(task.t for task in trace)
