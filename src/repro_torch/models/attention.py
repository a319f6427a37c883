"""Attention blocks: GQA (llama-style) and MLA (deepseek/minicpm-style)
(`repro/models/attention.py`).

Two execution paths per block:
  * prefill (and a cache-less forward): full-sequence causal attention
    through `kernels.ops.flash_attention` (the CUDA kernel on the card, the
    plain version on the CPU); with a cache, GQA writes K and V into it and
    MLA its latents (`c_kv`, `k_rope`);
  * decode: one new token against the cache, plain masked attention as in
    the reference's `_gqa_decode_body` and its absorbed `_mla_decode_body`
    (the reference has no kernel there).

The reference's mesh paths (context-parallel prefill, `shard_map` decode)
and its sharding constraints belong to a later slice: on one card the
constraints are no-ops and are left out.  Caches are updated in place
(one buffer per layer for the whole request, where the reference returns
new arrays).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (ParamModule, apply_rope, dense, f32,
                                       rms_norm)


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


def _out(p, o: torch.Tensor) -> torch.Tensor:
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



# --------------------------------------------------------------------------
# MLA (multi-head latent attention)
# --------------------------------------------------------------------------
class MLA(ParamModule):
    def __init__(self, cfg, dtype, device):
        super().__init__(dtype, device)
        d, h = cfg.d_model, cfg.n_heads
        nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        if cfg.q_lora_rank:
            self.add("w_q_a", (d, cfg.q_lora_rank))
            self.add("q_a_norm", (cfg.q_lora_rank,), "ones")
            self.add("w_q_b", (cfg.q_lora_rank, h, nope + rope_d))
        else:
            self.add("w_q", (d, h, nope + rope_d))
        self.add("w_kv_a", (d, cfg.kv_lora_rank + rope_d))
        self.add("kv_a_norm", (cfg.kv_lora_rank,), "ones")
        self.add("w_kv_b", (cfg.kv_lora_rank, h, nope + cfg.v_head_dim))
        self.add("w_o", (h, cfg.v_head_dim, d))


def mla_cache_shapes(cfg, batch: int, max_len: int
                     ) -> Dict[str, Tuple[int, ...]]:
    return {"c_kv": (batch, max_len, cfg.kv_lora_rank),
            "k_rope": (batch, max_len, cfg.qk_rope_head_dim)}


def _mla_q(p: MLA, x, cfg, positions):
    """-> (q_nope [B,S,H,nope], q_rope [B,S,H,rope] with RoPE applied)."""
    nope = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        qa = rms_norm(dense(x, p.w_q_a), p.q_a_norm, cfg.norm_eps)
        q = _heads(qa, p.w_q_b)
    else:
        q = _heads(x, p.w_q)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    return q[..., :nope], q_rope


def _mla_latents(p: MLA, x, cfg, positions):
    """-> (c_kv [B,S,r] normed, k_rope [B,S,rope] with RoPE applied): what
    the cache holds, one k_rope shared by every head."""
    r = cfg.kv_lora_rank
    kv_a = dense(x, p.w_kv_a)                                 # [B,S,r+rope]
    c_kv = rms_norm(kv_a[..., :r], p.kv_a_norm, cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., None, r:], positions,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_apply(p: MLA, x, cfg, *, positions, cache=None, decode_pos=None
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: [B,S,D].  Prefill expands the latents to per-head K [B,S,H,nope +
    rope] and V [B,S,H,v] and runs the attention kernel with Dh != Dv (its
    softmax scale 1/sqrt(nope + rope)); `cache` is written in place."""
    if cache is not None and decode_pos is not None:          # decode
        return _mla_decode(p, x, cfg, cache, decode_pos)
    nope = cfg.qk_nope_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latents(p, x, cfg, positions)
    kv = _heads(c_kv, p.w_kv_b)                               # [B,S,H,nope+v]
    h = kv.shape[2]
    # the kernel takes contiguous operands: k and q are built whole, v
    # copied out of the strided slice
    k = torch.cat([kv[..., :nope],
                   k_rope[:, :, None, :].expand(-1, -1, h, -1)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = kv[..., nope:].contiguous()
    out = _out(p, kops.flash_attention(q, k, v, causal=True))
    if cache is not None:                                     # prefill into cache
        s = x.shape[1]
        cache["c_kv"][:, :s].copy_(c_kv)
        cache["k_rope"][:, :s].copy_(k_rope)
    return out, cache


def _mla_decode_body(qc, q_rope, c_new, kr_new, c_kv, k_rope, w_uv,
                     pos: int):
    """Absorbed MLA decode.  qc: [B,H,r] (q_nope @ W_uk) and q_rope:
    [B,H,rope], both f32 and pre-scaled by 1/sqrt(nope + rope); c_kv:
    [B,S,r] and k_rope: [B,S,rope], the caches, where the new latents are
    written at `pos`; w_uv: [r,H,v] -> out [B,H,v] f32.  The latent dot
    qc . c_kv equals q_nope . k_nope (the absorption identity), and
    positions past `pos` (exact zeros in the reference) are not read."""
    c_kv[:, pos].copy_(c_new)
    k_rope[:, pos].copy_(kr_new)
    c, kr = f32(c_kv[:, :pos + 1]), f32(k_rope[:, :pos + 1])
    s = (torch.einsum("bhr,bsr->bhs", qc, c)
         + torch.einsum("bhk,bsk->bhs", q_rope, kr))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    ctx = torch.einsum("bhs,bsr->bhr", e, c)
    ctx = ctx / e.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhr,rhv->bhv", ctx, f32(w_uv))


def _mla_decode(p: MLA, x, cfg, cache, pos: int):
    nope = cfg.qk_nope_head_dim
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)             # [B,1,H,*]
    c_new, kr_new = _mla_latents(p, x, cfg, positions)
    w_uk, w_uv = p.w_kv_b[..., :nope], p.w_kv_b[..., nope:]   # [r,H,*]
    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_head_dim)
    qc = torch.einsum("bhk,rhk->bhr", f32(q_nope[:, 0]), f32(w_uk)) * scale
    out = _mla_decode_body(qc, f32(q_rope[:, 0]) * scale, c_new[:, 0],
                           kr_new[:, 0], cache["c_kv"], cache["k_rope"],
                           w_uv, pos)
    # the output projection in f32, cast once (unlike GQA's `_out`)
    out = torch.einsum("bhv,hvd->bd", out, f32(p.w_o))
    return out.to(x.dtype)[:, None], cache


# --------------------------------------------------------------------------
# Dispatch on the config's attention kind
# --------------------------------------------------------------------------
def attention_module(cfg, dtype, device) -> ParamModule:
    return (MLA if cfg.attn_kind == "mla" else GQA)(cfg, dtype, device)


def attention_apply(p, x, cfg, **kw):
    if cfg.attn_kind == "mla":
        return mla_apply(p, x, cfg, **kw)
    return gqa_apply(p, x, cfg, **kw)


def attention_cache_shapes(cfg, batch: int, max_len: int):
    if cfg.attn_kind == "mla":
        return mla_cache_shapes(cfg, batch, max_len)
    return gqa_cache_shapes(cfg, batch, max_len)
