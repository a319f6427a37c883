"""Dispatch between the CUDA kernels and their plain versions.

The rule is the tensor's device, nothing else: operands on the CPU take
the plain PyTorch version (`ref`); operands on a CUDA device take the
hand-written kernel (`gp_kernel`, `flash_attention`, `mamba2_ssd`,
`rwkv6_wkv`), whose wrapper launches it or raises.  The LM kernels also
take `meta` operands (the dry run, `repro_torch.launch.cost`): they go
the card's way, through the same autograd Functions, to the wrappers'
meta route, which records each call and launches nothing.  Any other
device raises, and so does `meta` for the GP kernels.
There is no automatic choice and no fallback from a kernel that fails to
build or launch.

While a cost recorder is active, a plain version runs under the kernel's
scope (`_build.scope`), and its backward's autograd nodes under the
backward kernel's (`_build.scope_backward`), so that an analysis on the
CPU can tell the ops inside each kernel's plain version from the rest.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import gp_kernel, ref
from repro_torch.kernels import mamba2_ssd as ssd_kernel
from repro_torch.kernels import rwkv6_wkv as wkv_kernel


def _on_cpu(t: torch.Tensor) -> bool:
    """True for CPU operands (the plain version), False for CUDA ones (the
    kernel); raises on any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for operands on {t.device}")
    return t.device.type == "cpu"


def _lm_on_cpu(t: torch.Tensor) -> bool:
    """`_on_cpu` for the LM kernels, where `meta` takes the kernel's
    route as CUDA does."""
    return t.device.type != "meta" and _on_cpu(t)


def _plain(name: str, fn, *args, **kwargs):
    """The plain version `fn(*args, **kwargs)` of kernel `name`, under its
    scope and its backward's while a cost recorder is active."""
    if not _build.recorders_active():
        return fn(*args, **kwargs)
    with _build.scope(name):
        out = fn(*args, **kwargs)
    _build.scope_backward(f"{name}_bwd",
                          out if isinstance(out, tuple) else (out,), args)
    return out


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q: [B,Sq,H,Dh]; k/v: [B,Skv,Hkv,Dh|Dv] -> [B,Sq,H,Dv]; GQA by the
    kv-head index, causal diagonal offset Skv - Sq.  Differentiable: on
    the CPU through autograd of the plain version, on a card through the
    backward kernel (`flash_attention.FlashAttention`)."""
    if _lm_on_cpu(q):
        return _plain("flash_attention", ref.attention, q, k, v,
                      causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return fa_kernel.FlashAttention.apply(q, k, v, causal)
    return fa_kernel.flash_attention(q, k, v, causal=causal)


def mamba2_ssd(x, dt, a, b, c, d, state: Optional[torch.Tensor] = None, *,
               chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba2 SSD: (y [B,S,H,P], final state [B,H,P,N] f32).
    Differentiable: on the CPU through autograd of the plain version, on a
    card through the backward kernel (`mamba2_ssd.Mamba2SSD`)."""
    if _lm_on_cpu(x):
        return _plain("mamba2_ssd", ref.mamba2_ssd, x, dt, a, b, c, d,
                      state, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, d, state)):
        return ssd_kernel.Mamba2SSD.apply(x, dt, a, b, c, d, state)
    return ssd_kernel.mamba2_ssd(x, dt, a, b, c, d, state, chunk=chunk)


def rwkv6_wkv(r, k, v, w, u, state: Optional[torch.Tensor] = None, *,
              chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked RWKV6 WKV with the bonus u: (out [B,S,H,V] in r's dtype,
    final state [B,H,K,V] f32).  Differentiable: on the CPU through
    autograd of the plain version, on a card through the backward kernel
    (`rwkv6_wkv.RWKV6WKV`)."""
    if _lm_on_cpu(r):
        return _plain("rwkv6_wkv", ref.rwkv6_wkv, r, k, v, w, u, state,
                      chunk=chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, state)):
        return wkv_kernel.RWKV6WKV.apply(r, k, v, w, u, state)
    return wkv_kernel.rwkv6_wkv(r, k, v, w, u, state, chunk=chunk)


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
