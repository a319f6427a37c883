"""Gaussian-process regression in PyTorch (paper §III-B), the port of
`repro/uq/gp.py`.

Posterior mean/variance through a Cholesky solve, ARD RBF / Matérn-5/2
kernels (covariance assembly through `kernels.ops`: the CUDA kernel on
the card, the plain version on the CPU), and marginal-likelihood training
with Adam on log-parameters.  Multi-output data share one kernel matrix —
one Cholesky, M solves.  Cholesky and triangular solves go to
`torch.linalg`, as the JAX reference leaves them to XLA.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import ops as kops

# Row counts a query chunk is accounted at in `predict_batch`: batches are
# chunked at the largest bucket, and each chunk is recorded under the
# smallest bucket that holds it.  Eager PyTorch compiles nothing per shape,
# so the port launches each chunk at its own size; the accounting is kept
# so that shape-bill callers and tests read the same plan as `repro`'s.
PREDICT_BUCKETS = (64, 256, 1024)

# (n_train, bucket) -> number of batched-predict launches.  Diagnostic
# state only; tests assert the chunking discipline from it.
predict_batch_shapes: collections.Counter = collections.Counter()

# Optional repro_torch.obs.Tracer: when set, `predict_batch` emits one
# `gp.predict_batch` instant per launch.
_obs_tracer = None


def set_obs_tracer(tracer) -> None:
    """Attach (or detach, with None) the module-wide launch tracer."""
    global _obs_tracer
    _obs_tracer = tracer


def bucket_of(n: int) -> int:
    """The bucket a chunk of `n` queries is accounted at.  Raises for
    chunks beyond the largest bucket: `predict_batch` splits those first,
    and so should any caller."""
    if n > PREDICT_BUCKETS[-1]:
        raise ValueError(f"chunk of {n} rows exceeds the largest predict "
                         f"bucket ({PREDICT_BUCKETS[-1]}); chunk it first")
    return next(b for b in PREDICT_BUCKETS if n <= b)


def bucket_launches(s: int) -> list:
    """The bucket of every launch `predict_batch` issues for a batch of
    `s` queries: full largest-bucket chunks plus one remainder."""
    if s <= 0:
        return []
    cap = PREDICT_BUCKETS[-1]
    full, rest = divmod(s, cap)
    out = [cap] * full
    if rest:
        out.append(bucket_of(rest))
    return out


def as_f32(a, device: torch.device) -> torch.Tensor:
    """Any array-like (numpy, list, tensor on any device) as an f32 tensor
    on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).contiguous()
    return torch.tensor(np.asarray(a, np.float32), device=device)


@dataclasses.dataclass
class GPParams:
    log_lengthscale: torch.Tensor    # [D]
    log_variance: torch.Tensor       # []
    log_noise: torch.Tensor          # []

    @staticmethod
    def init(d: int, device: torch.device) -> "GPParams":
        return GPParams(torch.zeros((d,), device=device),
                        torch.zeros((), device=device),
                        torch.log(torch.tensor(0.1, device=device)))

    def tree(self) -> Dict[str, torch.Tensor]:
        return {"ls": self.log_lengthscale, "var": self.log_variance,
                "noise": self.log_noise}

    @staticmethod
    def from_tree(t) -> "GPParams":
        return GPParams(t["ls"], t["var"], t["noise"])


@dataclasses.dataclass
class GPPosterior:
    """Trained GP conditioned on (x, y); y is [N, M].  Outputs are
    standardised internally (per-column mean/std) — predict() returns
    results on the original scale.  All tensors live on one device."""
    params: GPParams
    x: torch.Tensor                  # [N, D]
    y: torch.Tensor                  # [N, M] raw observations
    y_mean: torch.Tensor             # [M]
    y_std: torch.Tensor              # [M]
    chol: torch.Tensor               # [N, N]
    alpha: torch.Tensor              # [N, M]  (K + s2 I)^-1 (y - mean)/std
    kind: str = "rbf"
    # cached L^-1 (lower-triangular inverse Cholesky factor) for the
    # batched predict path, built lazily by `ensure_linv`
    linv: Optional[torch.Tensor] = None


def _hyper(params: GPParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lengthscale, variance) under the log-parameter clips, which keep
    NLML optimisation out of Cholesky-breaking territory."""
    ls = torch.exp(torch.clamp(params.log_lengthscale, -5.0, 5.0))
    var = torch.exp(torch.clamp(params.log_variance, -8.0, 8.0))
    return ls, var


def _kernel(params: GPParams, x1, x2, kind: str) -> torch.Tensor:
    ls, var = _hyper(params)
    return kops.gp_kernel_matrix(x1, x2, ls, var, kind)


def jitter(params: GPParams) -> torch.Tensor:
    """The diagonal load of K: noise s2 plus a jitter that scales with the
    signal variance, keeping the f32 Cholesky conditioned even in the
    noiseless-interpolation regime the NLML optimum sometimes reaches."""
    s2 = torch.exp(2.0 * torch.clamp(params.log_noise, -5.0, 5.0))
    _, var = _hyper(params)
    return s2 + 1e-5 * (var + 1.0)


def _chol_factor(params: GPParams, x, kind: str) -> torch.Tensor:
    n = x.shape[0]
    k = _kernel(params, x, x, kind)
    eye = torch.eye(n, dtype=torch.float32, device=x.device)
    chol, info = torch.linalg.cholesky_ex(k + jitter(params) * eye)
    # a failed factorisation is NaN, as XLA's Cholesky returns it (and no
    # host sync to find out): fit zeroes the NaN gradient and recovers
    return torch.where(info == 0, chol, torch.full_like(chol, math.nan))


# Public aliases for the surrogate engines (`repro_torch.uq.engine`).
kernel_matrix = _kernel
chol_factor = _chol_factor


def _cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # row-major, as the predict kernel takes alpha (LAPACK/cuSOLVER
    # results may come back column-major)
    return torch.cholesky_solve(b, chol, upper=False).contiguous()


def nlml(tree, x, y, kind: str = "rbf") -> torch.Tensor:
    """Negative log marginal likelihood, summed over output columns."""
    params = GPParams.from_tree(tree)
    y2 = y if y.dim() == 2 else y[:, None]
    yc = y2 - y2.mean(0, keepdim=True)
    n, m = yc.shape
    chol = _chol_factor(params, x, kind)
    alpha = _cho_solve(chol, yc)
    logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
    quad = (yc * alpha).sum()
    return 0.5 * (quad + m * logdet + m * n * math.log(2.0 * math.pi))


_CLIP_LO = {"ls": -5.0, "var": -8.0, "noise": -5.0}
_CLIP_HI = {"ls": 5.0, "var": 8.0, "noise": 2.0}


def _fit(x, y, kind: str, steps: int, lr: float):
    """Adam on the log-parameters, as `repro.uq.gp._fit`: NaN gradients
    (a transient Cholesky breakdown) are zeroed, and every step ends in
    the per-key clips.  Returns (tree, losses [steps])."""
    tree = GPParams.init(x.shape[1], x.device).tree()
    m = {k: torch.zeros_like(v) for k, v in tree.items()}
    v = {k: torch.zeros_like(a) for k, a in tree.items()}
    losses = []
    for t in range(1, steps + 1):
        leaves = {k: a.detach().requires_grad_() for k, a in tree.items()}
        loss = nlml(leaves, x, y, kind)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(loss.detach())
        with torch.no_grad():
            new = {}
            for (k, p), g in zip(leaves.items(), grads):
                g = torch.nan_to_num(g)
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * g * g
                mh = m[k] / (1 - 0.9 ** t)
                vh = v[k] / (1 - 0.999 ** t)
                p = p - lr * mh / (torch.sqrt(vh) + 1e-8)
                new[k] = torch.clamp(p, _CLIP_LO[k], _CLIP_HI[k])
            tree = new
    return tree, (torch.stack(losses) if losses else torch.zeros(0))


def _standardise(y2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = y2.mean(0)
    std = torch.clamp(y2.std(0, correction=0), min=1e-8)
    return mean, std


def fit(x, y, kind: str = "rbf", steps: int = 200,
        lr: float = 5e-2) -> GPPosterior:
    """Type-II MLE: optimise (lengthscales, variance, noise) by Adam, on
    the package's device."""
    dev = device_mod.get()
    x = as_f32(x, dev)
    y = as_f32(y, dev)
    y2 = y if y.dim() == 2 else y[:, None]
    mean, std = _standardise(y2)
    yn = (y2 - mean) / std
    tree, _ = _fit(x, yn, kind, steps, lr)
    params = GPParams.from_tree(tree)
    chol = _chol_factor(params, x, kind)
    alpha = _cho_solve(chol, yn)
    return GPPosterior(params=params, x=x, y=y2, y_mean=mean, y_std=std,
                       chol=chol, alpha=alpha, kind=kind)


def predict(post: GPPosterior, x_star) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean [S, M] and per-output variance [S, M] at x_star
    (eqs. 3-4); the latent variance is shared across outputs (one
    kernel), scaled back by each column's standardisation std."""
    x_star = as_f32(x_star, post.x.device)
    if x_star.dim() == 1:
        x_star = x_star[None]
    params = post.params
    ks = _kernel(params, post.x, x_star, post.kind)              # [N, S]
    mean = post.y_mean[None] + (ks.T @ post.alpha) * post.y_std[None]
    v = torch.linalg.solve_triangular(post.chol, ks, upper=False)
    prior = torch.exp(params.log_variance)
    var = torch.clamp(prior - (v * v).sum(0), min=1e-12)          # [S]
    # original scale PER OUTPUT: each column maps back through its own
    # y_std^2 (growth rate and mode frequency differ in magnitude)
    return mean, var[:, None] * (post.y_std ** 2)[None, :]


def _ensure_linv(post: GPPosterior) -> torch.Tensor:
    """Cache L^-1 on the posterior: one triangular inversion at first use
    buys a batched predict that is a single fused launch.

    Staleness contract: `linv` is valid iff it matches `chol`.  Every
    update path constructs a NEW GPPosterior (`recondition`, `fit`, the
    engine block-update); `invalidate_linv` exists for code that mutates
    a posterior's factor in place.  L^-1 comes from a triangular solve
    against the identity, so its upper part is exactly 0 — the predict
    kernel relies on that."""
    if post.linv is None:
        n = post.x.shape[0]
        eye = torch.eye(n, dtype=torch.float32, device=post.chol.device)
        post.linv = torch.linalg.solve_triangular(
            post.chol, eye, upper=False).contiguous()
    return post.linv


ensure_linv = _ensure_linv


def invalidate_linv(post: GPPosterior) -> None:
    """Drop the cached L^-1 so the next `predict_batch` rebuilds it.
    Required after any in-place change to `post.chol`."""
    post.linv = None


def _predict_batch(post: GPPosterior, linv, x_star):
    ls, var = _hyper(post.params)
    mean_n, qf = kops.gp_predict(post.x, x_star, ls, var, post.alpha, linv,
                                 post.kind)
    mean = post.y_mean[None] + mean_n * post.y_std[None]         # [S, M]
    lat = torch.clamp(var - qf, min=1e-12)                       # [S]
    return mean, lat[:, None] * (post.y_std ** 2)[None, :]       # [S, M]


def predict_batch(post: GPPosterior, x_star
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched posterior predict through the fused `kops.gp_predict`:
    mean [S, M], variance [S, M], same contract as `predict`.  Batches
    are chunked at the largest bucket (`PREDICT_BUCKETS`), one launch per
    chunk, each recorded in `predict_batch_shapes`."""
    x_star = as_f32(x_star, post.x.device)
    if x_star.dim() == 1:
        x_star = x_star[None]
    s = x_star.shape[0]
    m = post.y.shape[1]
    if s == 0:
        z = torch.zeros((0, m), dtype=torch.float32, device=post.x.device)
        return z, z.clone()
    linv = _ensure_linv(post)
    cap = PREDICT_BUCKETS[-1]
    means, variances = [], []
    for lo in range(0, s, cap):
        chunk = x_star[lo:lo + cap]
        bucket = bucket_of(chunk.shape[0])
        predict_batch_shapes[(int(post.x.shape[0]), bucket)] += 1
        if _obs_tracer is not None:
            _obs_tracer.instant(
                "gp.predict_batch",
                args={"n": int(chunk.shape[0]), "bucket": bucket,
                      "train_n": int(post.x.shape[0])})
        mean, var = _predict_batch(post, linv, chunk)
        means.append(mean)
        variances.append(var)
    if len(means) == 1:
        return means[0], variances[0]
    return torch.cat(means), torch.cat(variances)


def recondition(post: GPPosterior, x, y) -> GPPosterior:
    """Posterior with the SAME hyperparameters on a replacement dataset
    (recency-capped surrogates, sliding windows): one Cholesky rebuild,
    no re-training."""
    dev = post.x.device
    x = as_f32(x, dev)
    y = as_f32(y, dev)
    y2 = y if y.dim() == 2 else y[:, None]
    mean, std = _standardise(y2)
    chol = _chol_factor(post.params, x, post.kind)
    alpha = _cho_solve(chol, (y2 - mean) / std)
    return GPPosterior(params=post.params, x=x, y=y2, y_mean=mean,
                       y_std=std, chol=chol, alpha=alpha, kind=post.kind)


def coerce_new_data(x_new, y_new, device: Optional[torch.device] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalise a conditioning batch to (x [K, D], y [K, M]) on `device`
    (the package's device when None): a 1-D y is a column when x carries
    several rows, and a single multi-output row otherwise.  Shared by
    `condition` and every engine backend."""
    dev = device if device is not None else device_mod.get()
    x_new = torch.atleast_2d(as_f32(x_new, dev))
    y_new2 = as_f32(y_new, dev)
    if y_new2.dim() == 1:
        y_new2 = y_new2[:, None] if x_new.shape[0] > 1 else y_new2[None, :]
    return x_new, y_new2


def condition(post: GPPosterior, x_new, y_new) -> GPPosterior:
    """Add observations and re-condition; hyperparameters are kept —
    only the Cholesky is rebuilt."""
    x_new, y_new2 = coerce_new_data(x_new, y_new, post.x.device)
    return recondition(post, torch.cat([post.x, x_new]),
                       torch.cat([post.y, y_new2]))


# --------------------------------------------------------------------------
# carrying a posterior across packages
# --------------------------------------------------------------------------
def posterior_from_numpy(d: Dict, device) -> GPPosterior:
    """A posterior from numpy arrays: `d` holds params ({"ls", "var",
    "noise"}), x, y, y_mean, y_std, chol, alpha and kind, as
    `posterior_to_numpy` (or a caller exporting a `repro.uq.gp.GPPosterior`)
    writes them.  Both packages then compute on the same numbers."""
    dev = torch.device(device)
    p = d["params"]
    params = GPParams(as_f32(p["ls"], dev), as_f32(p["var"], dev),
                      as_f32(p["noise"], dev))
    y = as_f32(d["y"], dev)
    return GPPosterior(params=params, x=as_f32(d["x"], dev),
                       y=y if y.dim() == 2 else y[:, None],
                       y_mean=as_f32(d["y_mean"], dev),
                       y_std=as_f32(d["y_std"], dev),
                       chol=as_f32(d["chol"], dev),
                       alpha=as_f32(d["alpha"], dev), kind=str(d["kind"]))


def posterior_to_numpy(post: GPPosterior) -> Dict:
    """Inverse of `posterior_from_numpy`."""
    def a(t):
        return t.detach().cpu().numpy()
    return {"params": {k: a(v) for k, v in post.params.tree().items()},
            "x": a(post.x), "y": a(post.y), "y_mean": a(post.y_mean),
            "y_std": a(post.y_std), "chol": a(post.chol),
            "alpha": a(post.alpha), "kind": post.kind}
