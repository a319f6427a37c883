"""Plain PyTorch versions of the GP kernels (`repro/kernels/ref.py`, GP
part).

These are the reference the CUDA kernels in `gp_kernel` are held
against on the card, and what the dispatcher runs for tensors on the
CPU.  The formulas follow the JAX reference line for line (norms minus
twice the cross term, clamped at 0), so that both round alike.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def gp_kernel_matrix(x1: torch.Tensor, x2: torch.Tensor,
                     lengthscale: torch.Tensor, variance: torch.Tensor,
                     kind: str = "rbf") -> torch.Tensor:
    """x1: [..., N, D]; x2: [..., M, D]; ARD lengthscale: [D]
    -> [..., N, M] (f32).  Leading dimensions batch (one per expert)."""
    ls = lengthscale.to(torch.float32)
    x1s = x1.to(torch.float32) / ls
    x2s = x2.to(torch.float32) / ls
    d2 = ((x1s ** 2).sum(-1)[..., :, None] + (x2s ** 2).sum(-1)[..., None, :]
          - 2.0 * x1s @ x2s.transpose(-1, -2))
    d2 = torch.clamp(d2, min=0.0)
    if kind == "rbf":
        k = torch.exp(-0.5 * d2)
    elif kind == "matern52":
        r = torch.sqrt(d2 + 1e-12)
        k = (1.0 + math.sqrt(5.0) * r + 5.0 / 3.0 * d2) \
            * torch.exp(-math.sqrt(5.0) * r)
    else:
        raise ValueError(kind)
    return variance.to(torch.float32) * k


def gp_predict(x_train: torch.Tensor, x_star: torch.Tensor,
               lengthscale: torch.Tensor, variance: torch.Tensor,
               alpha: torch.Tensor, linv: torch.Tensor, kind: str = "rbf"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched GP posterior predict.

    Returns (normalised mean [S, M], quadratic form [S]) where
    mean = Ks^T alpha and qf[s] = ||L^-1 ks||^2; the caller maps both
    back to the original output scale.
    """
    ks = gp_kernel_matrix(x_train, x_star, lengthscale, variance, kind)
    mean = ks.transpose(-1, -2) @ alpha
    v = linv @ ks
    qf = (v * v).sum(-2)
    return mean, qf


def gp_predict_experts(x_train: torch.Tensor, x_star: torch.Tensor,
                       lengthscale: torch.Tensor, variance: torch.Tensor,
                       alpha: torch.Tensor, linv: torch.Tensor,
                       kind: str = "rbf"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked local-GP ensemble predict: `gp_predict` batched over the
    expert axis.

    x_train: [E, N, D]; x_star: [E, S, D]; alpha: [E, N, M];
    linv: [E, N, N]; shared hyperparameters
    -> (normalised mean [E, S, M], quadratic form [E, S]).  Zero-padded
    training rows contribute nothing (alpha/linv zero there).
    """
    return gp_predict(x_train, x_star, lengthscale, variance, alpha, linv,
                      kind)
