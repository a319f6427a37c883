"""Dispatch between the CUDA kernels and their plain versions.

The rule is the tensor's device, nothing else: operands on the CPU take
the plain PyTorch version (`ref`); operands on a CUDA device take the
hand-written kernel (`gp_kernel`), whose wrapper launches it or raises.
There is no automatic choice and no fallback from a kernel that fails to
build or launch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import gp_kernel, ref


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def gp_kernel_matrix(x1, x2, lengthscale, variance, kind: str = "rbf"
                     ) -> torch.Tensor:
    """K(x1, x2) [N, M] = variance * k(d2) with ARD lengthscales."""
    if _on_cpu(x1):
        return ref.gp_kernel_matrix(x1, x2, lengthscale, variance, kind)
    return gp_kernel.gp_kernel_matrix(x1, x2, lengthscale, variance, kind)


def gp_predict(x_train, x_star, lengthscale, variance, alpha, linv,
               kind: str = "rbf") -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched GP posterior predict: (normalised mean [S, M], quadratic
    form ||L^-1 ks||^2 [S]) — covariance assembly, alpha product and the
    variance quadratic form fused in one launch on the card."""
    if _on_cpu(x_train):
        return ref.gp_predict(x_train, x_star, lengthscale, variance, alpha,
                              linv, kind)
    return gp_kernel.gp_predict(x_train, x_star, lengthscale, variance,
                                alpha, linv, kind)


def gp_predict_experts(x_train, x_star, lengthscale, variance, alpha, linv,
                       kind: str = "rbf"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked local-GP ensemble predict: every expert answers its routed
    query tile in ONE launch.  x_train: [E, N, D]; x_star: [E, S, D];
    alpha: [E, N, M]; linv: [E, N, N] -> (mean [E, S, M], qf [E, S])."""
    if _on_cpu(x_train):
        return ref.gp_predict_experts(x_train, x_star, lengthscale, variance,
                                      alpha, linv, kind)
    return gp_kernel.gp_predict_experts(x_train, x_star, lengthscale,
                                        variance, alpha, linv, kind)
