"""Mamba2 (state-space dual) block, used by zamba2 (`repro/models/ssm.py`).

Layout follows the reference Mamba2: fused in-projection producing
(z, x, B, C, dt), causal depthwise conv over (x, B, C), per-head scalar
decay SSD recurrence, gated RMSNorm, out-projection.  Prefill and training
go through `kernels.ops.mamba2_ssd` (the CUDA kernel on the card, and its
backward kernel when a gradient is recorded: the parameters a_log,
dt_bias and d_skip get theirs through it); decode is the one-step
recurrence.  The caches keep the reference's dtypes (the
activation dtype, the SSD state included, cast back to f32 on entry) and
are written in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import ParamModule, dense, rms_norm


def _dims(cfg):
    d_inner = cfg.ssm_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    conv_dim = d_inner + 2 * n
    return d_inner, n, h, conv_dim


class Mamba2(ParamModule):
    def __init__(self, cfg, dtype, device):
        super().__init__(dtype, device)
        d = cfg.d_model
        d_inner, n, h, conv_dim = _dims(cfg)
        self.add("w_in", (d, 2 * d_inner + 2 * n + h))
        self.add("conv_w", (cfg.ssm_conv, conv_dim), "normal")
        self.add("conv_b", (conv_dim,), "zeros")
        self.add("a_log", (h,), "zeros")
        self.add("d_skip", (h,), "ones")
        self.add("dt_bias", (h,), "zeros")
        self.add("norm", (d_inner,), "ones")
        self.add("w_out", (d_inner, d))


def mamba2_cache_shapes(cfg, batch: int) -> Dict[str, Tuple[int, ...]]:
    d_inner, n, h, conv_dim = _dims(cfg)
    return {"conv": (batch, cfg.ssm_conv - 1, conv_dim),
            "ssd": (batch, h, cfg.ssm_head_dim, n)}


def _split_proj(proj, cfg):
    d_inner, n, h, _ = _dims(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_inner + 2 * n]
    dt = proj[..., -h:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, prev: Optional[torch.Tensor] = None):
    """xbc: [B,S,C]; conv_w: [K,C] depthwise; prev: [B,K-1,C] state.  The
    K taps are unrolled in f32, as in the reference (a f32 conv would go
    through cuDNN, in TF32 by default)."""
    k = conv_w.shape[0]
    if prev is None:
        prev = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
    xp = torch.cat([prev.to(xbc.dtype), xbc], dim=1)
    s = xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + xp[:, i:i + s].float() * conv_w[i].float()
    out = out + conv_b.float()
    new_state = xp[:, -(k - 1):] if k > 1 else prev
    return F.silu(out).to(xbc.dtype), new_state


def mamba2_apply(p: Mamba2, x: torch.Tensor, cfg, *, cache=None,
                 decode: bool = False
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: [B,S,D] -> (out, cache or None); `cache` is written in place."""
    b, s, d = x.shape
    d_inner, n, h, conv_dim = _dims(cfg)
    proj = dense(x, p.w_in)
    z, xbc, dt = _split_proj(proj, cfg)
    prev_conv = cache["conv"] if cache is not None else None
    xbc, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b, prev_conv)
    xs = xbc[..., :d_inner].reshape(b, s, h, cfg.ssm_head_dim)
    b_in = xbc[..., d_inner:d_inner + n]
    c_in = xbc[..., d_inner + n:]
    dt = F.softplus(dt.float() + p.dt_bias.float())
    a = -torch.exp(p.a_log.float())
    state0 = cache["ssd"].float() if cache is not None else None
    if decode:
        # single-step recurrence (s == 1)
        dtt = dt[:, 0]                                          # [B,H]
        dec = torch.exp(dtt * a[None])
        x0 = xs[:, 0].float()
        dbx = torch.einsum("bh,bhp,bn->bhpn", dtt, x0, b_in[:, 0].float())
        st = dec[..., None, None] * state0 + dbx
        y = (torch.einsum("bhpn,bn->bhp", st, c_in[:, 0].float())
             + p.d_skip.float()[None, :, None] * x0)
        y = y[:, None].to(x.dtype)
        ssd_state = st
    else:
        y, ssd_state = kops.mamba2_ssd(
            xs.contiguous(), dt, a, b_in.contiguous(), c_in.contiguous(),
            p.d_skip, state0, chunk=cfg.ssm_chunk)
    y = y.reshape(b, s, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p.norm, cfg.norm_eps)
    out = dense(y, p.w_out)
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["ssd"].copy_(ssd_state)
    return out, cache
