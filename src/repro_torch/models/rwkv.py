"""RWKV6 ("Finch") block: time-mix with data-dependent decay + channel-mix
(`repro/models/rwkv.py`).

Faithful to arXiv:2404.05892: token-shift ddlerp with a shared low-rank
projection for the five mix targets (w, k, v, r, g), low-rank
data-dependent decay w_t, bonus u, per-head group norm, squared-relu
channel mix.  Prefill goes through `kernels.ops.rwkv6_wkv` (the CUDA kernel
on the card); decode is the one-step recurrence.  The caches keep the
reference's dtypes (the activation dtype, the WKV state included, cast to
f32 on entry) and are written in place.  Where the reference sums in f32
(`preferred_element_type=f32`), the port multiplies f32 copies of the
operands: bf16 products are exact in f32, so only the summation order
differs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import ParamModule, dense

_N_MIX = 5  # w, k, v, r, g


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


class RWKV6Layer(ParamModule):
    """One layer's parameters, with the reference's flat names
    (`rwkv6_defs`)."""

    def __init__(self, cfg, dtype, device):
        super().__init__(dtype, device)
        d, h, kd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
        lw, lm, f = cfg.rwkv_decay_lora, cfg.rwkv_mix_lora, cfg.d_ff
        for name in ("ln1", "ln2"):
            self.add(f"{name}_w", (d,), "ones")
            self.add(f"{name}_b", (d,), "zeros")
        # --- time mix ---
        self.add("mix_x", (d,), "zeros")
        self.add("mix_base", (_N_MIX, d), "zeros")
        self.add("mix_w1", (d, _N_MIX * lm))
        self.add("mix_w2", (_N_MIX, lm, d))
        self.add("decay_base", (d,), "zeros")
        self.add("decay_w1", (d, lw))
        self.add("decay_w2", (lw, d))
        self.add("bonus_u", (h, kd), "normal")
        for name in ("w_r", "w_k", "w_v", "w_g"):
            self.add(name, (d, d))
        self.add("gn_w", (d,), "ones")
        self.add("gn_b", (d,), "zeros")
        self.add("w_o", (d, d))
        # --- channel mix ---
        self.add("cmix_k", (d,), "zeros")
        self.add("cmix_r", (d,), "zeros")
        self.add("cw_k", (d, f))
        self.add("cw_r", (d, d))
        self.add("cw_v", (f, d))


def rwkv6_cache_shapes(cfg, batch: int) -> Dict[str, Tuple[int, ...]]:
    d, h, kd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    return {"shift_t": (batch, 1, d), "shift_c": (batch, 1, d),
            "wkv": (batch, h, kd, kd)}


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The x_{t-1} stream: [B,S,D]."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                n_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-head layer norm over head_dim.  x: [B,S,D]."""
    bsz, s, d = x.shape
    xh = x.reshape(bsz, s, n_heads, d // n_heads).float()
    mu = xh.mean(-1, keepdim=True)
    var = (xh - mu).square().mean(-1, keepdim=True)
    y = ((xh - mu) * torch.rsqrt(var + eps)).reshape(bsz, s, d)
    return (y * w.float() + b.float()).to(x.dtype)


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ w [D, F] summed and kept in f32."""
    return torch.matmul(x.float(), w.float())


def _time_mix(p: RWKV6Layer, x, cfg, prev_shift, wkv_state, decode):
    b, s, d = x.shape
    h, kd = cfg.rwkv_heads, cfg.rwkv_head_dim
    xprev = _token_shift(x, prev_shift)
    dx = xprev - x
    # shared ddlerp: five data-dependent mixing coefficients
    xx = x + dx * p.mix_x.to(x.dtype)
    lora = torch.tanh(_dot_f32(xx, p.mix_w1)).reshape(b, s, _N_MIX, -1)
    mix = (p.mix_base.float()[None, None]
           + torch.einsum("bsml,mld->bsmd", lora, p.mix_w2.float()))
    xm = x[:, :, None] + dx[:, :, None] * mix.to(x.dtype)      # [B,S,5,D]
    x_w, x_k, x_v, x_r, x_g = (xm[:, :, i] for i in range(_N_MIX))
    # data-dependent decay in (0, 1)
    dec = torch.tanh(_dot_f32(x_w, p.decay_w1))
    dec = p.decay_base.float()[None, None] + dec @ p.decay_w2.float()
    w = torch.exp(-torch.exp(dec - 2.0))                       # init near ~0.87
    r = dense(x_r, p.w_r).reshape(b, s, h, kd)
    k = dense(x_k, p.w_k).reshape(b, s, h, kd)
    v = dense(x_v, p.w_v).reshape(b, s, h, kd)
    g = F.silu(dense(x_g, p.w_g).float()).to(x.dtype)
    wh = w.reshape(b, s, h, kd)
    state0 = wkv_state.float() if wkv_state is not None else None
    if decode:
        # one-step recurrence
        st = state0
        rt, kt, vt = (t[:, 0].float() for t in (r, k, v))
        kv = kt[..., :, None] * vt[..., None, :]
        out = torch.einsum("bhk,bhkv->bhv", rt,
                           st + p.bonus_u.float()[None, :, :, None] * kv)
        new_state = wh[:, 0][..., None] * st + kv
        out = out[:, None].reshape(b, 1, d).to(x.dtype)
    else:
        out, new_state = kops.rwkv6_wkv(r, k, v, wh.contiguous(),
                                        p.bonus_u, state0)
        out = out.reshape(b, s, d)
    out = _group_norm(out, p.gn_w, p.gn_b, h) * g
    return dense(out, p.w_o), x[:, -1:], new_state


def _channel_mix(p: RWKV6Layer, x, prev_shift):
    xprev = _token_shift(x, prev_shift)
    dx = xprev - x
    x_k = x + dx * p.cmix_k.to(x.dtype)
    x_r = x + dx * p.cmix_r.to(x.dtype)
    k = F.relu(dense(x_k, p.cw_k).float()).square()
    r = torch.sigmoid(dense(x_r, p.cw_r).float())
    out = r * _dot_f32(k.to(x.dtype), p.cw_v)
    return out.to(x.dtype), x[:, -1:]


def rwkv6_apply(p: RWKV6Layer, x: torch.Tensor, cfg, *, cache=None,
                decode: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One RWKV6 layer (time-mix + channel-mix, pre-LN residual).
    x: [B,S,D] -> (x, cache or None); `cache` is written in place."""
    st = cache["shift_t"] if cache is not None else None
    sc = cache["shift_c"] if cache is not None else None
    wkv = cache["wkv"] if cache is not None else None
    h1 = layer_norm(x, p.ln1_w, p.ln1_b, cfg.norm_eps)
    tm, new_st, new_wkv = _time_mix(p, h1, cfg, st, wkv, decode)
    x = x + tm
    h2 = layer_norm(x, p.ln2_w, p.ln2_b, cfg.norm_eps)
    cm, new_sc = _channel_mix(p, h2, sc)
    x = x + cm
    if cache is not None:
        cache["shift_t"].copy_(new_st)
        cache["shift_c"].copy_(new_sc)
        cache["wkv"].copy_(new_wkv)
    return x, cache
