"""Online runtime predictors for UQ task scheduling.

The paper's central scheduling difficulty is that UQ task runtimes are
"potentially unpredictable" — GS2 runs vary from minutes to hours with the
seven physics inputs.  HQ's *time request* is a static per-workload hint;
these predictors replace it with estimates that improve online as tasks
complete:

  * `QuantileEstimator` — a running per-model quantile tracker.  Its p50
    is the cost estimate; its p95 feeds the executor's straggler-mitigation
    threshold (replacing the ad-hoc scan over completed results).
  * `GPRuntimePredictor` — a Gaussian process ON THE INPUT PARAMETERS,
    reusing `repro_torch.uq.gp`.  It learns the runtime surface t(theta) from
    completed tasks: fit once at `min_fit` observations, then condition
    incrementally (`gp.condition`, one Cholesky rebuild, no re-training)
    and re-fit hyperparameters every `refit_every` completions.  Runtimes
    are modelled in log-space (positive, heavy-tailed).

Both are thread-safe: the live `Executor` feeds completions from worker
threads while the monitor thread queries quantiles.
"""
from __future__ import annotations

import bisect
import math
import threading
from collections import deque
from typing import (TYPE_CHECKING, Any, Deque, Dict, List, Optional,
                    Protocol, Sequence, runtime_checkable)

from repro_torch.sched.registry import register_predictor

if TYPE_CHECKING:                              # hint-only: keeps repro_torch.sched
    from repro_torch.core.task import EvalRequest    # import-cycle-free


@runtime_checkable
class RuntimePredictor(Protocol):
    """What a scheduling policy / executor needs from a predictor."""

    def predict(self, req: EvalRequest) -> Optional[float]:
        """Expected compute seconds for `req`; None if unknown."""
        ...

    def observe(self, req: EvalRequest, compute_t: float) -> None:
        """Feed one completed task's measured compute time."""
        ...

    def quantile(self, q: float, model_name: Optional[str] = None
                 ) -> Optional[float]:
        """Runtime quantile over completions (pooled, or one model's)."""
        ...

    # Predictors MAY additionally expose
    #     predict_many(reqs) -> List[Optional[float]]
    # — one batched pass semantically equal to [predict(r) for r in reqs].
    # `SchedulingPolicy.costs` uses it when present, so bulk re-costing
    # (heap rebuilds, backlog ledgers) runs at batch cost: the GP
    # predictor scores the whole queue through `gp.predict_batch`
    # (bounded compile shapes, fused launches) instead of issuing one
    # `gp.predict` per task.


def flatten_parameters(parameters: Any) -> Optional[List[float]]:
    """Best-effort flatten of an UM-Bridge parameter payload ([[...]] lists)
    into a fixed feature vector; None if it contains non-numeric leaves OR
    flattens to nothing.  An empty/degenerate payload must NOT read as a
    valid zero-length feature vector: the GP predictor locks its feature
    dimension on the first flattenable request, and `_dim = 0` would pin
    it to a featureless GP forever after."""
    out: List[float] = []

    def walk(v) -> bool:
        if isinstance(v, (int, float)):
            out.append(float(v))
            return True
        if isinstance(v, (list, tuple)):
            return all(walk(u) for u in v)
        try:                                   # numpy / jax scalars & arrays
            import numpy as _np
            arr = _np.asarray(v, dtype=float)
            out.extend(float(x) for x in arr.ravel())
            return True
        except Exception:                      # noqa: BLE001
            return False

    if not walk(parameters) or not out:
        return None
    return out


def request_features(req: EvalRequest) -> Optional[List[float]]:
    """`flatten_parameters(req.parameters)`, cached ON the request.

    Every cost-scoring pass over a queue re-reads each request's feature
    vector (GP predict, offload trust gate, heap rebuilds) and a request
    survives many passes (requeues, migrations, re-costings), so the
    flatten walk — a Python recursion over the whole payload — runs once
    per request instead of once per scoring.  Parameters are treated as
    immutable after submission (the UM-Bridge contract); the cache is a
    1-tuple so an unflattenable payload (None) is cached too."""
    cached = req.__dict__.get("_feature_cache")
    if cached is not None:
        return cached[0]
    feats = flatten_parameters(req.parameters)
    req.__dict__["_feature_cache"] = (feats,)
    return feats


class _RunningQuantiles:
    """Bounded sorted window of observations with linear-interp quantiles."""

    def __init__(self, window: int):
        self.window = window
        self._ordered: List[float] = []        # sorted values
        # arrival order (for eviction): a deque, because a full window
        # evicts on EVERY observation — on the executor's completion path
        # — and list.pop(0) is an O(window) memmove each time
        self._fifo: Deque[float] = deque()
        self.count = 0

    def add(self, x: float):
        self.count += 1
        self._fifo.append(x)
        bisect.insort(self._ordered, x)
        if len(self._fifo) > self.window:
            old = self._fifo.popleft()
            del self._ordered[bisect.bisect_left(self._ordered, old)]

    def quantile(self, q: float) -> Optional[float]:
        s = self._ordered
        if not s:
            return None
        i = min(max(q, 0.0), 1.0) * (len(s) - 1)
        lo, hi = int(math.floor(i)), int(math.ceil(i))
        return s[lo] + (s[hi] - s[lo]) * (i - lo)


@register_predictor("quantile")
class QuantileEstimator:
    """Per-model running quantile estimator.

    `predict` returns the model's p50 (the single best constant guess under
    absolute loss); `quantile` exposes arbitrary quantiles — the executor's
    straggler monitor asks for p95.
    """

    def __init__(self, window: int = 512, predict_quantile: float = 0.5,
                 min_observed: int = 3):
        self.window = window
        self.predict_quantile = predict_quantile
        self.min_observed = min_observed
        self._lock = threading.Lock()
        self._per_model: Dict[str, _RunningQuantiles] = {}
        self._pooled = _RunningQuantiles(window)

    def observe(self, req: EvalRequest, compute_t: float) -> None:
        with self._lock:
            rq = self._per_model.get(req.model_name)
            if rq is None:
                rq = self._per_model[req.model_name] = \
                    _RunningQuantiles(self.window)
            rq.add(compute_t)
            self._pooled.add(compute_t)

    def predict(self, req: EvalRequest) -> Optional[float]:
        with self._lock:
            rq = self._per_model.get(req.model_name)
            if rq is None or rq.count < self.min_observed:
                return None
            return rq.quantile(self.predict_quantile)

    def predict_many(self, reqs: Sequence[EvalRequest]
                     ) -> List[Optional[float]]:
        """Batched `predict`: one lock acquisition and one quantile
        evaluation per distinct model for the whole batch — a UQ queue is
        thousands of requests over a handful of models."""
        with self._lock:
            per_model: Dict[str, Optional[float]] = {}
            out: List[Optional[float]] = []
            for req in reqs:
                name = req.model_name
                if name not in per_model:
                    rq = self._per_model.get(name)
                    per_model[name] = (
                        None if rq is None or rq.count < self.min_observed
                        else rq.quantile(self.predict_quantile))
                out.append(per_model[name])
            return out

    def predict_many_with_sd(self, reqs: Sequence[EvalRequest]
                             ) -> List[tuple]:
        """Batched (mean, sd) pairs: the p50 estimate plus a spread proxy
        from the central quantiles — sd ≈ (p84 − p16) / 2, the normal
        1-sigma band read off the empirical window.  Feeds the
        uncertainty-aware packing path; (None, None) where unknown."""
        with self._lock:
            per_model: Dict[str, tuple] = {}
            out: List[tuple] = []
            for req in reqs:
                name = req.model_name
                if name not in per_model:
                    rq = self._per_model.get(name)
                    if rq is None or rq.count < self.min_observed:
                        per_model[name] = (None, None)
                    else:
                        mean = rq.quantile(self.predict_quantile)
                        sd = (rq.quantile(0.84) - rq.quantile(0.16)) / 2.0
                        per_model[name] = (mean, max(sd, 0.0))
                out.append(per_model[name])
            return out

    def quantile(self, q: float, model_name: Optional[str] = None
                 ) -> Optional[float]:
        with self._lock:
            rq = (self._per_model.get(model_name) if model_name
                  else self._pooled)
            return rq.quantile(q) if rq else None

    def n_observed(self, model_name: Optional[str] = None) -> int:
        with self._lock:
            if model_name is None:
                return self._pooled.count
            rq = self._per_model.get(model_name)
            return rq.count if rq else 0

    def version(self) -> object:
        """Changes whenever predictions may have changed (every obs)."""
        return self.n_observed()

    # -- persistence (broker journal / Executor.snapshot) ---------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-able state: each model's observation window (arrival
        order) plus lifetime counts, so `min_observed` gates and
        `version()` resume where they left off."""
        with self._lock:
            return {
                "kind": "quantile",
                "per_model": {m: list(rq._fifo)
                              for m, rq in self._per_model.items()},
                "counts": {m: rq.count
                           for m, rq in self._per_model.items()},
                "pooled_count": self._pooled.count,
            }

    def load_state(self, state: Dict[str, Any]) -> None:
        """Inverse of `state_dict`.  The pooled window is rebuilt from
        the per-model windows (original interleaving is not preserved —
        per-model predictions, the scheduling signal, round-trip
        exactly; pooled quantiles are window-equivalent)."""
        with self._lock:
            self._per_model = {}
            self._pooled = _RunningQuantiles(self.window)
            counts = state.get("counts", {})
            for model, vals in state.get("per_model", {}).items():
                rq = _RunningQuantiles(self.window)
                for v in vals:
                    rq.add(float(v))
                    self._pooled.add(float(v))
                rq.count = int(counts.get(model, rq.count))
                self._per_model[model] = rq
            self._pooled.count = int(state.get("pooled_count",
                                               self._pooled.count))


@register_predictor("gp")
class GPRuntimePredictor:
    """GP regression of log-runtime on the task's input parameters.

    This is the predictor the paper's premise calls for: GS2 runtimes vary
    *with the inputs*, so a surrogate over theta (the same trick the paper
    plays for the physics QoI with its GP surrogate) recovers per-task cost
    estimates no static time request can express.

    Falls back to the per-model quantile estimate until `min_fit`
    observations with a consistent feature dimension have arrived, and for
    requests whose parameters cannot be flattened.

    `backend` selects the surrogate engine (`repro_torch.uq.engine`) carrying
    the posterior: "exact" (default — every conditioning is a full
    Cholesky refit, the reference behaviour), "incremental" (rank-k
    block updates, O(n²) per conditioning batch — the always-on-service
    choice once completions stream in faster than refits amortise), or
    "partitioned" (cap-bounded local-GP ensemble for training sets one
    Cholesky can't hold).
    """

    def __init__(self, min_fit: int = 8, refit_every: int = 32,
                 condition_every: int = 8, max_points: int = 256,
                 kind: str = "rbf", fit_steps: int = 100, window: int = 512,
                 backend: str = "exact"):
        self.min_fit = min_fit
        self.refit_every = refit_every
        # batch size for incremental conditioning: every posterior size is
        # a fresh XLA compile of gp.predict, so absorbing completions in
        # batches (not one-by-one) keeps compile churn ~1/condition_every
        self.condition_every = condition_every
        self.max_points = max_points
        self.kind = kind
        self.fit_steps = fit_steps
        self.backend = backend
        self._lock = threading.Lock()
        self._fallback = QuantileEstimator(window=window)
        self._xs: List[List[float]] = []       # feature rows (fixed dim)
        self._ys: List[float] = []             # log(compute_t + eps)
        self._dim: Optional[int] = None
        self._engine = None                    # repro_torch.uq.engine backend
        self._in_post = 0                      # rows of _xs in the posterior
        self._since_refit = 0
        self._post_version = 0                 # bumped on posterior installs
        self.n_fits = 0

    @property
    def _post(self):
        """The underlying `GPPosterior` (None before the first fit) —
        read-only introspection; the engine owns the conditioning."""
        eng = self._engine
        return getattr(eng, "post", eng)

    # -- RuntimePredictor -----------------------------------------------
    def observe(self, req: EvalRequest, compute_t: float) -> None:
        self._fallback.observe(req, compute_t)
        feats = request_features(req)
        if feats is None:
            return
        from repro_torch.uq import engine as uq_engine
        import numpy as np
        fit_data = cond_args = None
        with self._lock:
            if self._dim is None:
                self._dim = len(feats)
            if len(feats) != self._dim:
                return                         # heterogeneous payload: skip
            self._xs.append(feats)
            self._ys.append(math.log(max(compute_t, 1e-6)))
            self._since_refit += 1
            if len(self._xs) < self.min_fit:
                return
            if self._engine is None or self._since_refit >= self.refit_every:
                if len(self._xs) > self.max_points:    # keep the most recent
                    del self._xs[:-self.max_points]
                    del self._ys[:-self.max_points]
                fit_data = (np.asarray(self._xs, dtype=float),
                            np.asarray(self._ys, dtype=float))
                self._since_refit = 0          # claim the refit
            elif len(self._xs) - self._in_post >= self.condition_every:
                cond_args = (self._engine, self._xs[self._in_post:],
                             self._ys[self._in_post:])
                self._in_post = len(self._xs)
        # the expensive JAX work runs OUTSIDE the lock so concurrent
        # predict()/observe() calls are never stalled behind a refit;
        # a stale-by-one posterior install is harmless (best-effort)
        if fit_data is not None:
            new_engine = uq_engine.fit_engine(
                fit_data[0], fit_data[1], self.backend, kind=self.kind,
                steps=self.fit_steps)
            with self._lock:
                self._engine = new_engine
                self._in_post = len(fit_data[0])
                self._post_version += 1
                self.n_fits += 1
        elif cond_args is not None:
            new_engine = cond_args[0].condition(cond_args[1], cond_args[2])
            with self._lock:
                if self._engine is cond_args[0]:  # drop if a refit raced
                    self._engine = new_engine
                    self._post_version += 1

    def predict(self, req: EvalRequest) -> Optional[float]:
        feats = request_features(req)
        with self._lock:
            eng = self._engine
            dim_ok = feats is not None and self._dim == len(feats or [])
        if eng is None or not dim_ok:
            return self._fallback.predict(req)
        mean, _ = eng.predict([feats])
        return float(math.exp(float(mean[0, 0])))

    def predict_many(self, reqs: Sequence[EvalRequest]
                     ) -> List[Optional[float]]:
        """Batched `predict`: every GP-eligible request in the batch is
        scored by ONE `gp.predict_batch` pass (bucket-padded, at most
        `len(gp.PREDICT_BUCKETS)` compile shapes per training-set size,
        one fused launch per chunk) instead of one `gp.predict` — and one
        XLA dispatch — per task.  Feature vectors come from the
        per-request cache, so `flatten_parameters` never re-walks a
        payload on re-costing.  Ineligible requests (no posterior yet,
        unflattenable or wrong-dimension payloads) take the per-model
        quantile fallback in one batch as well."""
        with self._lock:
            eng = self._engine
            dim = self._dim
        feats = [request_features(r) for r in reqs]
        out: List[Optional[float]] = [None] * len(reqs)
        gp_idx: List[int] = []
        fb_idx: List[int] = []
        for i, f in enumerate(feats):
            if eng is not None and f is not None and dim == len(f):
                gp_idx.append(i)
            else:
                fb_idx.append(i)
        if gp_idx:
            import numpy as np
            x = np.asarray([feats[i] for i in gp_idx], dtype=np.float32)
            mean, _ = eng.predict_batch(x)
            secs = np.exp(mean.cpu().numpy()[:, 0].astype(np.float64))
            for j, i in enumerate(gp_idx):
                out[i] = float(secs[j])
        if fb_idx:
            fb = self._fallback.predict_many([reqs[i] for i in fb_idx])
            for j, i in enumerate(fb_idx):
                out[i] = fb[j]
        return out

    def predict_many_with_sd(self, reqs: Sequence[EvalRequest]
                             ) -> List[tuple]:
        """Batched (mean seconds, sd seconds) pairs for the
        uncertainty-aware packing path — same eligibility split as
        `predict_many`, same ONE `predict_batch` pass, but the posterior
        variance rides along.  Runtimes are modelled log-normally
        (mu, sigma² in log-space), so the predictive sd in seconds is
        mean_s·sqrt(expm1(sigma²)); sigma² is clamped before `expm1` —
        an untrained posterior's prior variance must saturate the risk
        term, not overflow it.  (None, None) where no estimate exists."""
        with self._lock:
            eng = self._engine
            dim = self._dim
        feats = [request_features(r) for r in reqs]
        out: List[tuple] = [(None, None)] * len(reqs)
        gp_idx: List[int] = []
        fb_idx: List[int] = []
        for i, f in enumerate(feats):
            if eng is not None and f is not None and dim == len(f):
                gp_idx.append(i)
            else:
                fb_idx.append(i)
        if gp_idx:
            import numpy as np
            x = np.asarray([feats[i] for i in gp_idx], dtype=np.float32)
            mean, var = eng.predict_batch(x)
            mu = mean.cpu().numpy()[:, 0].astype(np.float64)
            s2 = np.minimum(var.cpu().numpy()[:, 0].astype(np.float64), 20.0)
            secs = np.exp(mu)
            sds = secs * np.sqrt(np.expm1(np.maximum(s2, 0.0)))
            for j, i in enumerate(gp_idx):
                out[i] = (float(secs[j]), float(sds[j]))
        if fb_idx:
            fb = self._fallback.predict_many_with_sd(
                [reqs[i] for i in fb_idx])
            for j, i in enumerate(fb_idx):
                out[i] = fb[j]
        return out

    def version(self) -> object:
        """Changes only when predictions may have changed: per posterior
        install once fitted, per observation while on the fallback."""
        with self._lock:
            if self._engine is None:
                return ("fallback", self._fallback.n_observed())
            return ("post", self._post_version)

    def quantile(self, q: float, model_name: Optional[str] = None
                 ) -> Optional[float]:
        return self._fallback.quantile(q, model_name)

    def n_observed(self, model_name: Optional[str] = None) -> int:
        return self._fallback.n_observed(model_name)

    # -- persistence (broker journal / Executor.snapshot) ---------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-able state: the engine BACKEND NAME and the conditioning
        set (feature rows + log-runtimes), plus the quantile fallback.
        The fitted posterior itself is not serialised — `load_state`
        refits the same backend from the same data, which is cheaper
        than it sounds (one `fit_engine` call) and keeps the journal
        free of jax arrays."""
        with self._lock:
            return {
                "kind": "gp",
                "backend": self.backend,
                "gp_kind": self.kind,
                "dim": self._dim,
                "xs": [list(row) for row in self._xs],
                "ys": [float(y) for y in self._ys],
                "n_fits": self.n_fits,
                "fallback": self._fallback.state_dict(),
            }

    def load_state(self, state: Dict[str, Any]) -> None:
        """Inverse of `state_dict`: restores the conditioning set AND
        the engine backend recorded in the state — a broker restored
        from a journal re-costs with the surrogate it was running, not
        whatever backend the fresh constructor defaulted to."""
        self._fallback.load_state(state.get("fallback", {}))
        xs = [[float(v) for v in row] for row in state.get("xs", [])]
        ys = [float(y) for y in state.get("ys", [])]
        backend = str(state.get("backend", self.backend))
        kind = str(state.get("gp_kind", self.kind))
        new_engine = None
        if len(xs) >= self.min_fit:
            from repro_torch.uq import engine as uq_engine
            import numpy as np
            new_engine = uq_engine.fit_engine(
                np.asarray(xs, dtype=float), np.asarray(ys, dtype=float),
                backend, kind=kind, steps=self.fit_steps)
        with self._lock:
            self.backend = backend
            self.kind = kind
            self._xs = xs
            self._ys = ys
            dim = state.get("dim")
            self._dim = (int(dim) if dim is not None
                         else (len(xs[0]) if xs else None))
            self._engine = new_engine
            self._in_post = len(xs) if new_engine is not None else 0
            self._since_refit = 0
            self._post_version += 1
            self.n_fits = int(state.get("n_fits", self.n_fits))
            if new_engine is not None:
                self.n_fits += 1


# Backend variants by name (the registry resolves names via a no-arg
# call, so these are factories, not subclasses): `predictor="gp"` keeps
# the exact reference path; the variants opt a deployment into O(n²)
# conditioning or the cap-bounded ensemble without touching call sites.
@register_predictor("gp-incremental")
def _gp_incremental() -> GPRuntimePredictor:
    return GPRuntimePredictor(backend="incremental")


@register_predictor("gp-partitioned")
def _gp_partitioned() -> GPRuntimePredictor:
    return GPRuntimePredictor(backend="partitioned")
