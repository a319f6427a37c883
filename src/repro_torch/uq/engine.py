"""Pluggable surrogate engines: exact, incremental and partitioned GPs —
the port of `repro/uq/engine.py`.

Every consumer of the posterior (runtime prediction in
`sched.predictor`, offload trust gates in `sched.offload`, Bayesian
quadrature in `uq.qoi`) conditions one posterior online through the
`SurrogateEngine` interface:

  * ``exact`` — every `condition` is a full re-factorisation
    (`gp.recondition`), O(n³) per update; the reference the others are
    pinned against.
  * ``incremental`` — rank-k block Cholesky updates of the factor and its
    cached inverse, O(n²k) per batch of k points, on the engine's device;
    periodic full re-factorisation bounds f32 drift.
  * ``partitioned`` — a local-GP ensemble routed by input region:
    recursive median splits bound every expert at ``expert_cap`` points,
    and predict answers all experts in ONE fused launch
    (`kops.gp_predict_experts`, the CUDA kernel on the card).

Engines are persistent: `condition` / `recondition` return a NEW engine
sharing hyperparameters.  Tensors stay on the device the posterior lives
on; predictions come back as tensors there.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, List, Optional, Protocol, Sequence, Tuple, \
    runtime_checkable

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import ops as kops
from repro_torch.uq import gp as gp_lib

BACKENDS = ("exact", "incremental", "partitioned")


@runtime_checkable
class SurrogateEngine(Protocol):
    """What every consumer of the posterior needs from a backend."""

    backend: str

    def n_train(self) -> int: ...
    def dim(self) -> int: ...
    def n_outputs(self) -> int: ...
    def condition(self, x_new, y_new) -> "SurrogateEngine": ...
    def recondition(self, x, y) -> "SurrogateEngine": ...
    def predict(self, x_star) -> Tuple[torch.Tensor, torch.Tensor]: ...
    def predict_batch(self, x_star) -> Tuple[torch.Tensor, torch.Tensor]: ...
    def latent_sd(self, thetas) -> np.ndarray: ...


class _EngineBase:
    """Shared surface: data views and the latent-sd trust metric."""

    backend = "base"

    # subclasses define .x / .y / .y_std / .kind / .params
    def n_train(self) -> int:
        return int(self.x.shape[0])

    def dim(self) -> int:
        return int(self.x.shape[1])

    def n_outputs(self) -> int:
        return int(self.y.shape[1])

    @property
    def device(self) -> torch.device:
        return self.x.device

    def latent_sd(self, thetas) -> np.ndarray:
        """Standardised (latent) posterior sd at each theta: the
        dimensionless trust metric the offload gate thresholds — one
        `predict_batch` pass for the whole batch."""
        _, var = self.predict_batch(np.asarray(thetas, np.float32))
        return (np.sqrt(var.cpu().numpy()[:, 0])
                / max(float(self.y_std[0]), 1e-12))

    def warm(self) -> None:
        """Run the single-row predict once, so that a push-time trust
        check under a dispatch lock never pays a first use (on the card:
        loading the kernels' library, building it if it is missing)."""
        self.predict_batch(self.x[:1])


# ===========================================================================
# exact — the O(n³) reference path
# ===========================================================================
class ExactEngine(_EngineBase):
    """Every `condition` re-factorises from scratch (`gp.recondition`),
    over the most recent ``max_points`` rows.  The differential reference
    the other backends are pinned against."""

    backend = "exact"

    def __init__(self, post: gp_lib.GPPosterior, *,
                 max_points: Optional[int] = None):
        self.post = post
        self.max_points = max_points

    # -- views -----------------------------------------------------------
    @property
    def x(self):
        return self.post.x

    @property
    def y(self):
        return self.post.y

    @property
    def y_std(self):
        return self.post.y_std

    @property
    def params(self):
        return self.post.params

    @property
    def kind(self):
        return self.post.kind

    # -- predict ---------------------------------------------------------
    def predict(self, x_star):
        return gp_lib.predict(self.post, x_star)

    def predict_batch(self, x_star):
        return gp_lib.predict_batch(self.post, x_star)

    # -- conditioning ----------------------------------------------------
    def _merged(self, x_new, y_new):
        x_new, y_new2 = gp_lib.coerce_new_data(x_new, y_new, self.device)
        x_all = torch.cat([self.post.x, x_new])
        y_all = torch.cat([self.post.y, y_new2])
        if self.max_points and x_all.shape[0] > self.max_points:
            x_all = x_all[-self.max_points:]   # keep the most recent
            y_all = y_all[-self.max_points:]
        return x_all, y_all

    def condition(self, x_new, y_new) -> "ExactEngine":
        x_all, y_all = self._merged(x_new, y_new)
        return type(self)(gp_lib.recondition(self.post, x_all, y_all),
                          max_points=self.max_points)

    def recondition(self, x, y) -> "ExactEngine":
        return type(self)(gp_lib.recondition(self.post, x, y),
                          max_points=self.max_points)


# ===========================================================================
# incremental — rank-k block Cholesky updates
# ===========================================================================
def _solve_tri(a: torch.Tensor, b: torch.Tensor,
               transpose: bool = False) -> torch.Tensor:
    """a⁻¹b (or a⁻ᵀb) for lower-triangular a."""
    if transpose:
        return torch.linalg.solve_triangular(a.T, b, upper=True)
    return torch.linalg.solve_triangular(a, b, upper=False)


def _eye(k: int, device: torch.device) -> torch.Tensor:
    return torch.eye(k, dtype=torch.float32, device=device)


def _alpha(chol: torch.Tensor, yn: torch.Tensor) -> torch.Tensor:
    """K⁻¹yn by two backward-stable triangular solves — the
    explicit-inverse product loses ~cond(K)·eps of accuracy."""
    return _solve_tri(chol, _solve_tri(chol, yn), transpose=True) \
        .contiguous()


def _standardise(y_all: torch.Tensor):
    return (y_all.mean(0),
            torch.clamp(y_all.std(0, correction=0), min=1e-8))


class _IncrementalState:
    """Growable append-only storage for one factor lineage, on the
    engine's device.

    The Cholesky factor, its inverse and the training window live in
    capacity-padded buffers; each engine generation pins its own fill
    level `n` and reads the [:n] views, which are frozen the moment they
    are written — appending rows [n, n+k) never touches them.  Appends go
    through `append` under the lock: only the lineage tip may extend in
    place; a raced or forked append, or one past capacity, copies the
    prefix into fresh buffers (1.25x capacity slack) and extends there."""

    def __init__(self, n: int, cap: int, d: int, m: int,
                 device: torch.device):
        self.lock = threading.Lock()
        self.n = n
        z = dict(dtype=torch.float32, device=device)
        self.chol = torch.zeros((cap, cap), **z)
        self.linv = torch.zeros((cap, cap), **z)
        self.x = torch.zeros((cap, d), **z)
        self.y = torch.zeros((cap, m), **z)

    @classmethod
    def from_arrays(cls, chol, linv, x, y) -> "_IncrementalState":
        n = chol.shape[0]
        st = cls(n, n, x.shape[1], y.shape[1], chol.device)
        st.chol[:n, :n] = chol
        st.linv[:n, :n] = linv
        st.x[:n] = x
        st.y[:n] = y
        return st

    def _fork(self, n: int, need: int) -> "_IncrementalState":
        cap = max(need, (need * 5) // 4 + 16)
        st = _IncrementalState(n, cap, self.x.shape[1], self.y.shape[1],
                               self.x.device)
        st.chol[:n, :n] = self.chol[:n, :n]
        st.linv[:n, :n] = self.linv[:n, :n]
        st.x[:n] = self.x[:n]
        st.y[:n] = self.y[:n]
        return st

    def append(self, n: int, x_new, y_new, s12, s22, li21, li22
               ) -> Tuple["_IncrementalState", bool]:
        """Write the new factor block after row n; returns the state
        holding the result and whether a fork (copy) was needed."""
        k = x_new.shape[0]
        with self.lock:
            forked = self.n != n or self.chol.shape[0] < n + k
            st = self._fork(n, n + k) if forked else self
            st.chol[n:n + k, :n] = s12.T
            st.chol[n:n + k, n:n + k] = s22
            st.linv[n:n + k, :n] = li21
            st.linv[n:n + k, n:n + k] = li22
            st.x[n:n + k] = x_new
            st.y[n:n + k] = y_new
            st.n = n + k
        return st, forked


class IncrementalEngine(_EngineBase):
    """O(n²k) conditioning by extending the Cholesky factor in place of
    rebuilding it.

    For new points X_k against the factored K_n = L Lᵀ:

        L' = [[L,    0  ],          S21 = (L⁻¹ K(X_n, X_k))ᵀ
              [S21,  S22]],         S22 S22ᵀ = K_kk − S21 S21ᵀ

    and the cached inverse factor extends the same way
    (L'⁻¹ = [[L⁻¹, 0], [−S22⁻¹ S21 L⁻¹, S22⁻¹]]), so the fused
    `predict_batch` path never pays the O(n³) triangular inversion.  The
    standardisation and alpha are recomputed over the full window with
    two O(n²m) products against the maintained inverse.

    Every ``refactor_every`` updates — and whenever the update block is
    not positive-definite or the recency window slides (`max_points`) —
    the engine falls back to one exact re-factorisation, bounding f32
    drift.
    """

    backend = "incremental"

    def __init__(self, post: Optional[gp_lib.GPPosterior] = None, *,
                 max_points: Optional[int] = None,
                 refactor_every: int = 64,
                 _internal: Optional[tuple] = None):
        self.max_points = max_points
        self.refactor_every = refactor_every
        self._post_cache: Optional[gp_lib.GPPosterior] = None
        if _internal is not None:
            (self.params, self.kind, self.y_mean, self.y_std,
             self._state, self._n, self._alpha, self._updates,
             self.stats) = _internal
            return
        self.params = post.params
        self.kind = post.kind
        self.y_mean = post.y_mean
        self.y_std = post.y_std
        chol = post.chol
        linv = post.linv if post.linv is not None else \
            _solve_tri(chol, _eye(chol.shape[0], chol.device))
        self._state = _IncrementalState.from_arrays(chol, linv, post.x,
                                                    post.y)
        self._n = chol.shape[0]
        self._alpha = post.alpha
        self._updates = 0                      # block updates since refactor
        # carried across persistent copies: diagnostics for tests/benchmarks
        self.stats = {"block_updates": 0, "refactors": 0, "forks": 0}

    def _successor(self, state, n, alpha, y_mean, y_std, *,
                   updates) -> "IncrementalEngine":
        return IncrementalEngine(
            max_points=self.max_points, refactor_every=self.refactor_every,
            _internal=(self.params, self.kind, y_mean, y_std,
                       state, n, alpha, updates, self.stats))

    # -- views -----------------------------------------------------------
    @property
    def x(self) -> torch.Tensor:
        return self._state.x[:self._n]

    @property
    def y(self) -> torch.Tensor:
        return self._state.y[:self._n]

    @property
    def post(self) -> gp_lib.GPPosterior:
        """This generation's `GPPosterior` over the frozen [:n] views (L⁻¹
        copied once per generation into the contiguous layout the predict
        kernel takes) — the predict-side consumers and the `.posterior`
        introspection surface read this."""
        if self._post_cache is None:
            n = self._n
            st = self._state
            self._post_cache = gp_lib.GPPosterior(
                params=self.params, x=st.x[:n], y=st.y[:n],
                y_mean=self.y_mean, y_std=self.y_std, chol=st.chol[:n, :n],
                alpha=self._alpha, kind=self.kind,
                linv=st.linv[:n, :n].contiguous())
        return self._post_cache

    # -- predict ---------------------------------------------------------
    def predict(self, x_star):
        return gp_lib.predict(self.post, x_star)

    def predict_batch(self, x_star):
        return gp_lib.predict_batch(self.post, x_star)

    # -- conditioning ----------------------------------------------------
    def condition(self, x_new, y_new) -> "IncrementalEngine":
        x_new, y_new2 = gp_lib.coerce_new_data(x_new, y_new, self.device)
        n, k = self._n, x_new.shape[0]
        slides = self.max_points and n + k > self.max_points
        if slides or self._updates + 1 >= self.refactor_every:
            x_all = torch.cat([self.x, x_new])
            y_all = torch.cat([self.y, y_new2])
            if slides:
                x_all = x_all[-self.max_points:]
                y_all = y_all[-self.max_points:]
            return self._refactor(x_all, y_all)
        st = self._state
        linv_v = st.linv[:n, :n]
        b = gp_lib.kernel_matrix(self.params, self.x, x_new, self.kind)
        c = gp_lib.kernel_matrix(self.params, x_new, x_new, self.kind) \
            + gp_lib.jitter(self.params) * _eye(k, self.device)
        # L⁻¹b through the maintained inverse factor: one product, no
        # triangular solve against the strided buffer view.  Drift from
        # the explicit inverse is bounded by the periodic refactor and the
        # breakdown fallback below.
        s12 = linv_v @ b                                       # [n, k]
        s22, info = torch.linalg.cholesky_ex(c - s12.T @ s12)  # [k, k]
        if int(info) != 0:                                     # breakdown
            return self._refactor(torch.cat([self.x, x_new]),
                                  torch.cat([self.y, y_new2]))
        li22 = _solve_tri(s22, _eye(k, self.device))
        li21 = -(li22 @ (s12.T @ linv_v))                      # [k, n]
        state, forked = st.append(n, x_new, y_new2, s12, s22, li21, li22)
        # alpha over the full window: the standardisation tracks the
        # stream (same as exact); the refactor recomputes alpha with
        # backward-stable solves and resets any accumulated drift
        y_all = state.y[:n + k]
        mean, std = _standardise(y_all)
        linv2 = state.linv[:n + k, :n + k]
        alpha = (linv2.T @ (linv2 @ ((y_all - mean) / std))).contiguous()
        self.stats["block_updates"] += 1
        if forked:
            self.stats["forks"] += 1
        return self._successor(state, n + k, alpha, mean, std,
                               updates=self._updates + 1)

    def recondition(self, x, y) -> "IncrementalEngine":
        x = gp_lib.as_f32(x, self.device)
        y = gp_lib.as_f32(y, self.device)
        return self._refactor(x, y if y.dim() == 2 else y[:, None])

    def _refactor(self, x_all: torch.Tensor, y_all: torch.Tensor
                  ) -> "IncrementalEngine":
        n = x_all.shape[0]
        kmat = gp_lib.kernel_matrix(self.params, x_all, x_all, self.kind) \
            + gp_lib.jitter(self.params) * _eye(n, self.device)
        chol = torch.linalg.cholesky(kmat)
        linv = _solve_tri(chol, _eye(n, self.device))
        mean, std = _standardise(y_all)
        alpha = _alpha(chol, (y_all - mean) / std)
        state = _IncrementalState.from_arrays(chol, linv, x_all, y_all)
        self.stats["refactors"] += 1
        return self._successor(state, n, alpha, mean, std, updates=0)


# ===========================================================================
# partitioned — region-routed local-GP ensemble
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class _Expert:
    """One local GP: immutable once factored (persistent engines share
    untouched experts across conditioning generations)."""
    x: torch.Tensor                  # [n, d]
    y: torch.Tensor                  # [n, m] raw
    chol: torch.Tensor               # [n, n]
    alpha: torch.Tensor              # [n, m]
    linv: torch.Tensor               # [n, n] lower-triangular
    centroid: np.ndarray             # [d] routing key


def _factor_expert(params: gp_lib.GPParams, kind: str, x, y,
                   y_mean, y_std) -> _Expert:
    """Exact factorisation of one cap-bounded expert under the SHARED
    standardisation, so expert predictions live on one scale.  L⁻¹ comes
    from a triangular solve against the identity: its upper part is
    exactly 0, which the fused predict kernel relies on."""
    chol = gp_lib.chol_factor(params, x, kind)
    alpha = torch.cholesky_solve((y - y_mean) / y_std, chol, upper=False)
    linv = _solve_tri(chol, _eye(int(x.shape[0]), x.device))
    return _Expert(x=x, y=y, chol=chol, alpha=alpha, linv=linv,
                   centroid=x.cpu().double().numpy().mean(axis=0))


def _median_parts(x_np: np.ndarray, idx: np.ndarray,
                  cap: int) -> List[np.ndarray]:
    """Recursive median split along the widest dimension until every
    part holds at most `cap` points — deterministic, no RNG."""
    if len(idx) <= cap:
        return [idx]
    sub = x_np[idx]
    dim = int(np.argmax(sub.max(axis=0) - sub.min(axis=0)))
    order = np.argsort(sub[:, dim], kind="stable")
    half = len(idx) // 2
    return (_median_parts(x_np, idx[order[:half]], cap)
            + _median_parts(x_np, idx[order[half:]], cap))


def _rows(t: torch.Tensor, ids: np.ndarray) -> torch.Tensor:
    return t[torch.as_tensor(ids, device=t.device)]


class PartitionedEngine(_EngineBase):
    """Local-GP ensemble routed by nearest expert centroid.

    Every expert holds at most ``expert_cap`` training points, so
    conditioning re-factors only the experts that received new points —
    O(cap³) each — and an expert that outgrows the cap splits at the
    median of its widest dimension.  Predict routes each query to its
    nearest centroid and answers ALL experts' routed queries in one fused
    stacked launch (`kops.gp_predict_experts`).

    ``shard`` is accepted for interface parity and does nothing: the JAX
    reference spreads the expert axis over several devices, and this port
    runs on one card.

    The standardisation (y_mean / y_std) is FROZEN at fit time — experts
    share one output scale.  ``max_points`` is accepted for interface
    parity and ignored: memory is already bounded per expert.
    """

    backend = "partitioned"

    def __init__(self, params: gp_lib.GPParams, kind: str, y_mean, y_std,
                 experts: Sequence[_Expert], *, expert_cap: int = 128,
                 shard: bool = False, _stats: Optional[dict] = None):
        self.params = params
        self.kind = kind
        self.y_mean = y_mean
        self.y_std = y_std
        self.experts = list(experts)
        self.expert_cap = int(expert_cap)
        self.shard = shard
        self.stats = _stats if _stats is not None else \
            {"splits": 0, "expert_refactors": 0}
        self._stack = None                     # cached fused-predict operands
        self._centroids = None                 # cached [E, d] routing matrix

    # -- construction ----------------------------------------------------
    @classmethod
    def fit(cls, x, y, *, expert_cap: int = 128, kind: str = "rbf",
            steps: int = 200, lr: float = 5e-2, fit_subsample: int = 512,
            shard: bool = False, **_ignored) -> "PartitionedEngine":
        """Train hyperparameters on a bounded subsample (type-II MLE is
        itself O(steps·n³)), standardise over the FULL data, then
        partition and factor the experts."""
        dev = device_mod.get()
        x = gp_lib.as_f32(x, dev)
        y = gp_lib.as_f32(y, dev)
        y2 = y if y.dim() == 2 else y[:, None]
        n = int(x.shape[0])
        stride = max(1, -(-n // max(int(fit_subsample), 1)))
        base = gp_lib.fit(x[::stride], y2[::stride], kind=kind,
                          steps=steps, lr=lr)
        y_mean, y_std = _standardise(y2)
        return cls._build(base.params, kind, y_mean, y_std, x, y2,
                          expert_cap=expert_cap, shard=shard)

    @classmethod
    def from_posterior(cls, post: gp_lib.GPPosterior, *,
                       expert_cap: int = 128, shard: bool = False,
                       **_ignored) -> "PartitionedEngine":
        """Re-partition an already-trained posterior's data under its
        hyperparameters and standardisation."""
        return cls._build(post.params, post.kind, post.y_mean, post.y_std,
                          post.x, post.y, expert_cap=expert_cap,
                          shard=shard)

    @classmethod
    def _build(cls, params, kind, y_mean, y_std, x, y2, *,
               expert_cap: int, shard: bool,
               _stats: Optional[dict] = None) -> "PartitionedEngine":
        x_np = x.cpu().double().numpy()
        parts = _median_parts(x_np, np.arange(len(x_np)), expert_cap)
        experts = [_factor_expert(params, kind, _rows(x, ids),
                                  _rows(y2, ids), y_mean, y_std)
                   for ids in parts]
        return cls(params, kind, y_mean, y_std, experts,
                   expert_cap=expert_cap, shard=shard, _stats=_stats)

    # -- views -----------------------------------------------------------
    @property
    def x(self):
        return torch.cat([e.x for e in self.experts])

    @property
    def y(self):
        return torch.cat([e.y for e in self.experts])

    @property
    def device(self) -> torch.device:
        return self.experts[0].x.device

    def n_train(self) -> int:
        return sum(int(e.x.shape[0]) for e in self.experts)

    def dim(self) -> int:
        return int(self.experts[0].x.shape[1])

    def n_outputs(self) -> int:
        return int(self.experts[0].y.shape[1])

    # -- routing ---------------------------------------------------------
    def _route(self, x_star: np.ndarray) -> np.ndarray:
        """Nearest-centroid expert index per query row."""
        if self._centroids is None:
            self._centroids = np.stack([e.centroid for e in self.experts])
        d2 = ((x_star[:, None, :].astype(np.float64)
               - self._centroids[None, :, :]) ** 2).sum(axis=2)
        return np.argmin(d2, axis=1)

    # -- conditioning ----------------------------------------------------
    def condition(self, x_new, y_new) -> "PartitionedEngine":
        x_new, y_new2 = gp_lib.coerce_new_data(x_new, y_new, self.device)
        routed = self._route(x_new.cpu().double().numpy())
        experts = list(self.experts)
        for eidx in np.unique(routed):
            rows = np.nonzero(routed == eidx)[0]
            e = experts[eidx]
            x_e = torch.cat([e.x, _rows(x_new, rows)])
            y_e = torch.cat([e.y, _rows(y_new2, rows)])
            if int(x_e.shape[0]) > self.expert_cap:
                # split at the median of the widest dimension: two
                # cap-bounded experts replace the overgrown one
                parts = _median_parts(x_e.cpu().double().numpy(),
                                      np.arange(int(x_e.shape[0])),
                                      self.expert_cap)
                halves = [_factor_expert(self.params, self.kind,
                                         _rows(x_e, ids), _rows(y_e, ids),
                                         self.y_mean, self.y_std)
                          for ids in parts]
                experts[eidx] = halves[0]
                experts.extend(halves[1:])
                self.stats["splits"] += 1
            else:
                experts[eidx] = _factor_expert(self.params, self.kind,
                                               x_e, y_e, self.y_mean,
                                               self.y_std)
            self.stats["expert_refactors"] += 1
        return PartitionedEngine(self.params, self.kind, self.y_mean,
                                 self.y_std, experts,
                                 expert_cap=self.expert_cap,
                                 shard=self.shard, _stats=self.stats)

    def recondition(self, x, y) -> "PartitionedEngine":
        x = gp_lib.as_f32(x, self.device)
        y = gp_lib.as_f32(y, self.device)
        y2 = y if y.dim() == 2 else y[:, None]
        return self._build(self.params, self.kind, self.y_mean, self.y_std,
                           x, y2, expert_cap=self.expert_cap,
                           shard=self.shard, _stats=self.stats)

    # -- fused predict ---------------------------------------------------
    def _stacked(self):
        """Stacked fused-predict operands [E, n_max, ...], zero-padded
        (padded training rows are exact: alpha and linv are zero there).
        Cached per engine generation."""
        if self._stack is None:
            n_max = max(int(e.x.shape[0]) for e in self.experts)
            e_n = len(self.experts)
            z = dict(dtype=torch.float32, device=self.device)
            xt = torch.zeros((e_n, n_max, self.dim()), **z)
            al = torch.zeros((e_n, n_max, self.n_outputs()), **z)
            li = torch.zeros((e_n, n_max, n_max), **z)
            for i, e in enumerate(self.experts):
                n = int(e.x.shape[0])
                xt[i, :n] = e.x
                al[i, :n] = e.alpha
                li[i, :n, :n] = e.linv
            self._stack = (xt, al, li)
        return self._stack

    def predict_batch(self, x_star) -> Tuple[torch.Tensor, torch.Tensor]:
        """Route, group by expert, answer every group in fused stacked
        launches.  Each launch carries ALL experts at a common per-expert
        query width (the bucket of the widest group, at most the largest
        bucket) — the same discipline as `gp.predict_batch`."""
        x_star = (x_star.cpu().numpy() if isinstance(x_star, torch.Tensor)
                  else np.asarray(x_star))
        x_star = np.atleast_2d(x_star.astype(np.float32))
        s = x_star.shape[0]
        m = self.n_outputs()
        if s == 0:
            z = torch.zeros((0, m), dtype=torch.float32, device=self.device)
            return z, z.clone()
        routed = self._route(x_star.astype(np.float64))
        cap = gp_lib.PREDICT_BUCKETS[-1]
        # per-expert query chunks of <= cap rows, answered in rounds of
        # one chunk per expert
        chunks: List[List[np.ndarray]] = []
        for eidx in range(len(self.experts)):
            rows = np.nonzero(routed == eidx)[0]
            chunks.append([rows[lo:lo + cap]
                           for lo in range(0, len(rows), cap)] or [rows])
        xt, al, li = self._stacked()
        ls, var = gp_lib._hyper(self.params)
        var_f = float(var)
        mean_out = np.zeros((s, m), np.float32)
        var_out = np.zeros((s, m), np.float32)
        y_mean = self.y_mean.cpu().numpy()
        y_std = self.y_std.cpu().numpy()
        n_rounds = max(len(c) for c in chunks)
        for rnd in range(n_rounds):
            groups = [c[rnd] if rnd < len(c) else c[0][:0] for c in chunks]
            width = max(len(g) for g in groups)
            if width == 0:
                continue
            bucket = gp_lib.bucket_of(width)
            xq = np.zeros((len(groups), bucket, self.dim()), np.float32)
            for e, g in enumerate(groups):
                if len(g):
                    xq[e, :len(g)] = x_star[g]
            key = ("part", len(self.experts), int(xt.shape[1]), bucket)
            gp_lib.predict_batch_shapes[key] += 1
            mean_n, qf = kops.gp_predict_experts(
                xt, torch.from_numpy(xq).to(self.device), ls, var, al, li,
                self.kind)
            mean_n = mean_n.cpu().numpy()
            lat = np.maximum(qf.cpu().numpy(), 0.0)
            lat = np.maximum(var_f - lat, 1e-12)
            for e, g in enumerate(groups):
                if not len(g):
                    continue
                mean_out[g] = y_mean[None] + mean_n[e, :len(g)] * y_std[None]
                var_out[g] = lat[e, :len(g), None] * (y_std ** 2)[None, :]
        return (torch.from_numpy(mean_out).to(self.device),
                torch.from_numpy(var_out).to(self.device))

    def predict(self, x_star) -> Tuple[torch.Tensor, torch.Tensor]:
        """Same routed path as `predict_batch` (one code path, one
        numerical behaviour)."""
        return self.predict_batch(x_star)


# ===========================================================================
# factories
# ===========================================================================
def wrap_posterior(post: gp_lib.GPPosterior, backend: str = "exact", *,
                   max_points: Optional[int] = None,
                   **backend_kw) -> SurrogateEngine:
    """Lift an already-trained `GPPosterior` into a backend engine."""
    if backend == "exact":
        return ExactEngine(post, max_points=max_points)
    if backend == "incremental":
        return IncrementalEngine(post, max_points=max_points, **backend_kw)
    if backend == "partitioned":
        return PartitionedEngine.from_posterior(post, **backend_kw)
    raise ValueError(f"unknown surrogate backend {backend!r}; "
                     f"expected one of {BACKENDS}")


def as_engine(obj: Any, backend: str = "exact", *,
              max_points: Optional[int] = None,
              **backend_kw) -> Optional[SurrogateEngine]:
    """Posterior -> engine (via `wrap_posterior`); engines and None pass
    through — the consumers' one-line compatibility shim."""
    if obj is None or isinstance(obj, _EngineBase):
        return obj
    return wrap_posterior(obj, backend, max_points=max_points, **backend_kw)


def fit_engine(x, y, backend: str = "exact", *, kind: str = "rbf",
               steps: int = 200, lr: float = 5e-2,
               max_points: Optional[int] = None,
               **backend_kw) -> SurrogateEngine:
    """Train hyperparameters and return a conditioned engine."""
    if backend == "partitioned":
        return PartitionedEngine.fit(x, y, kind=kind, steps=steps, lr=lr,
                                     **backend_kw)
    post = gp_lib.fit(x, y, kind=kind, steps=steps, lr=lr)
    return wrap_posterior(post, backend, max_points=max_points,
                          **backend_kw)
