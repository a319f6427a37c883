"""Shared straggler detection (`repro_torch.chaos.speculate`).

One p95 ladder for both drivers: `Executor._straggler_check` and
`simulate_cluster` call `find_stragglers` with the same candidate and
completion views, so a parity replay flags (and hedges) exactly the same
tasks at the same virtual times.

The ladder, per model (a pooled p95 misfires on heterogeneous models —
the fast model's p95 would re-issue every healthy task of a slow one):
predictor quantile when the predictor has seen enough of THIS model,
else a scan of this model's completions, else the pooled estimate, so a
model with too few completions of its own still gets straggler
protection.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple


def _scan_p95(xs: List[float]) -> float:
    xs = sorted(xs)
    return xs[int(0.95 * (len(xs) - 1))]


def straggler_cutoff(model: str, *, factor: float,
                     done_by_model: Dict[str, List[float]],
                     pooled: float, predictor: Any = None,
                     min_n: int = 5) -> float:
    """Re-issue cutoff (seconds in flight) for one model."""
    p95: Optional[float] = None
    n_obs = getattr(predictor, "n_observed", None)
    if predictor is not None and callable(n_obs) and n_obs(model) >= min_n:
        p95 = predictor.quantile(0.95, model)
    if p95 is None:
        ts = done_by_model.get(model)
        if ts is not None and len(ts) >= min_n:
            p95 = _scan_p95(ts)
    if p95 is None:
        p95 = pooled
    return factor * max(p95, 1e-3)


def find_stragglers(now: float,
                    candidates: Iterable[Tuple[str, str, float]],
                    completions: Iterable[Tuple[str, float]], *,
                    predictor: Any = None, factor: float,
                    min_n: int = 5) -> List[str]:
    """Task ids (in candidate order) running past their model's cutoff.

    ``candidates`` are ``(task_id, model, mark_t)`` for in-flight real
    attempts not yet hedged; ``completions`` are ``(model, compute_t)``
    for real (non-surrogate) successful attempts — the driver filters
    both, the ladder is shared."""
    if factor <= 0.0:
        return []
    done_by_model: Dict[str, List[float]] = {}
    for model, compute_t in completions:
        done_by_model.setdefault(model, []).append(compute_t)
    done = [t for ts in done_by_model.values() for t in ts]
    if len(done) < min_n:
        return []
    pooled = predictor.quantile(0.95) if predictor is not None else None
    if pooled is None:
        pooled = _scan_p95(done)
    out: List[str] = []
    cutoffs: Dict[str, float] = {}
    for task_id, model, mark_t in candidates:
        cutoff = cutoffs.get(model)
        if cutoff is None:
            cutoff = cutoffs[model] = straggler_cutoff(
                model, factor=factor, done_by_model=done_by_model,
                pooled=pooled, predictor=predictor, min_n=min_n)
        if now - mark_t > cutoff:
            out.append(task_id)
    return out
