"""GQA attention block (`repro/models/attention.py`, GQA part).

Two execution paths:
  * prefill (and a cache-less forward): full-sequence causal attention
    through `kernels.ops.flash_attention` (the CUDA kernel on the card, the
    plain version on the CPU); with a cache, K and V are written into it;
  * decode: one new token against the cache, plain masked attention as in
    the reference's `_gqa_decode_body` (the reference has no kernel there).

The reference's mesh paths (context-parallel prefill, `shard_map` decode)
and its sharding constraints belong to a later slice: on one card the
constraints are no-ops and are left out.  MLA is not ported yet.  Caches
are updated in place (one buffer per layer for the whole request, where
the reference returns new arrays).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import ParamModule, apply_rope, dense, rms_norm


class GQA(ParamModule):
    def __init__(self, cfg, dtype, device):
        super().__init__(dtype, device)
        d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        dh = cfg.resolved_head_dim
        self.add("w_q", (d, h, dh))
        self.add("w_k", (d, hkv, dh))
        self.add("w_v", (d, hkv, dh))
        self.add("w_o", (h, dh, d))
        if cfg.qk_norm:
            self.add("q_norm", (dh,), "ones")
            self.add("k_norm", (dh,), "ones")


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return dense(x, w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _project_qkv(p: GQA, x, cfg, positions):
    q, k, v = _heads(x, p.w_q), _heads(x, p.w_k), _heads(x, p.w_v)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p: GQA, o: torch.Tensor) -> torch.Tensor:
    """einsum('...hk,hkd->...d') as one matmul."""
    h, k, d = p.w_o.shape
    return dense(o.reshape(*o.shape[:-2], h * k), p.w_o.reshape(h * k, d))


def gqa_apply(p: GQA, x, cfg, *, positions, cache=None, decode_pos=None
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: [B,S,D].  Returns (out, cache or None); `cache` is written in
    place."""
    if cache is not None and decode_pos is not None:          # decode
        return _gqa_decode(p, x, cfg, cache, decode_pos)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = kops.flash_attention(q, k, v, causal=True)
    out = _out(p, out)
    if cache is not None:                                     # prefill into cache
        s = x.shape[1]
        cache["k"][:, :s].copy_(k)
        cache["v"][:, :s].copy_(v)
    return out, cache


def gqa_cache_shapes(cfg, batch: int, max_len: int
                     ) -> Dict[str, Tuple[int, ...]]:
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return {"k": (batch, max_len, hkv, dh), "v": (batch, max_len, hkv, dh)}


def _gqa_decode_body(q, k_new, v_new, ck, cv, pos: int):
    """q: [B,H,Dh]; ck/cv: [B,S,Hkv,Dh] -> out [B,H,Dh] in q's dtype.
    The new token is written at `pos`; positions past it are masked in the
    reference and contribute exact zeros there, so they are not read."""
    ck[:, pos].copy_(k_new)
    cv[:, pos].copy_(v_new)
    b, h, dh = q.shape
    hkv = ck.shape[2]
    qg = q.float().view(b, hkv, h // hkv, dh)                 # kv-head groups
    kc, vc = ck[:, :pos + 1].float(), cv[:, :pos + 1].float()
    s = torch.einsum("bgrk,bsgk->bgrs", qg, kc) / math.sqrt(dh)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    o = torch.einsum("bgrs,bsgk->bgrk", e, vc)
    out = o / e.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, dh).to(q.dtype)


def _gqa_decode(p: GQA, x, cfg, cache, pos: int):
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)              # [B,1,H,Dh]
    out = _gqa_decode_body(q[:, 0], k[:, 0], v[:, 0], cache["k"],
                           cache["v"], pos)
    return _out(p, out)[:, None], cache

