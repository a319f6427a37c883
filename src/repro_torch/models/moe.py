"""Mixture-of-Experts FFN on one device (`repro/models/moe.py`, its
mesh-free path: `_route`, `_swiglu_grouped`, `_moe_body` with no axis
name, `moe_apply` without a mesh).

Each token is routed to its top-k experts (a softmax router, or
deepseek-v3's sigmoid router with renormalised weights), the assignments
are packed into static [E, C, D] capacity buffers by a cumsum position
index over the token-major [T * k] assignments (an assignment past its
expert's capacity C = ceil(capacity_factor * T * k / E) is dropped), the
experts run as one grouped SwiGLU (`torch.bmm` over E), and the weighted
results are combined in f32.  The reference's expert-parallel branches
(`_moe_body_ep_all` and the two `shard_map` calls) are mesh code and stay
with ROADMAP.md Queue 1 item 16b.

Rounding follows the reference step by step:
  * the router logits are f32 (computed from f32 copies of x and the
    router: bf16 products are exact in f32, and the port runs with no
    TF32);
  * the grouped gate and up products are kept in f32, so silu(g) * u is
    formed in f32 and cast once; the down product is summed in f32 and
    cast to the activation dtype, then multiplied by the routing weight
    in that dtype;
  * the combine, and the shared expert's output added to it, are f32,
    cast once at the end.
On the card a bf16 product with an f32 result is `torch.bmm` / `torch.mm`
with `out_dtype=torch.float32` (cuBLAS, f32 sums); on the CPU, where that
overload is absent, the operands are widened to f32, which is exact.
PyTorch registers no derivative for that overload, so the product is an
autograd Function (`MatmulF32`) whose backward is the reference's
transpose rule: the f32 cotangent times the other operand widened to
f32, an f32 result cast once to the operand's dtype.

Three choices make the result independent of the device's scheduling:
  * the top k experts are the first k of a stable descending sort over E,
    so that equal scores break toward the lower expert index, as
    `jax.lax.top_k` breaks them;
  * the combine gathers each token's k slot outputs through the inverse
    map [T, k] -> slot and sums them over k in order, where the reference
    scatter-adds (`index_add_` is atomic on CUDA).  Its f32 sum is
    therefore fixed, and differs from the reference's order by rounding.
    Its backward writes each kept slot once (one (token, j) reads it; the
    many reads of the zero row land on a row that is dropped), so it
    needs no order of its own;
  * the dispatch `x_pad[buf_tok]`, whose autograd backward would
    scatter-add each token's k slot gradients, is a Function (`Dispatch`)
    whose backward gathers them through the same inverse map and sums
    them over k in order (`gather_sum`): the combine's forward, run on
    the gradient.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamModule, f32

# Callables that `observe` installs: each gets every `moe_apply` call's
# routing as (idx [T, k], keep [T, k], capacity).
_OBSERVERS: List[Callable] = []


class SharedExpert(ParamModule):
    """The always-on shared expert (deepseek-v3): a SwiGLU of width
    moe_d_ff * n_shared_experts, whatever the config's mlp_kind."""

    def __init__(self, cfg, dtype, device):
        super().__init__(dtype, device)
        d, fs = cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts
        self.add("w_gate", (d, fs))
        self.add("w_up", (d, fs))
        self.add("w_down", (fs, d))


class MoE(ParamModule):
    """`moe_defs`' names, shapes and init rules."""

    def __init__(self, cfg, dtype, device):
        super().__init__(dtype, device)
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.add("router", (d, e), "normal")
        self.add("w_gate", (e, d, f))
        self.add("w_up", (e, d, f))
        self.add("w_down", (e, f, d))
        self.shared = (SharedExpert(cfg, dtype, device)
                       if cfg.n_shared_experts else None)


@contextlib.contextmanager
def observe(fn: Callable):
    """Within the block, call `fn(idx, keep, capacity)` with the routing of
    every MoE layer run: idx [T, k] the experts chosen (best first), keep
    [T, k] whether each assignment found a slot, capacity the slots per
    expert.  The tensors stay on their device."""
    _OBSERVERS.append(fn)
    try:
        yield
    finally:
        _OBSERVERS.remove(fn)


class MatmulF32(torch.autograd.Function):
    """a @ b (2-D, or batched 3-D over the experts) of two activation-dtype
    operands, with an f32 result: the reference's `dot_general` with
    `preferred_element_type=f32`, and its transpose rule for a gradient
    (`jax/_src/lax/lax.py:_dot_general_transpose_lhs` / `_rhs`): the f32
    cotangent g times the other operand widened to f32, summed in f32 (no
    TF32) and cast once to the operand's dtype,
        grad_a = (g @ b.float().mT).to(a.dtype)
        grad_b = (a.float().mT @ g).to(b.dtype).
    The cotangent is never rounded to the operands' dtype.  A batched
    product takes its gradient one expert at a time, so that the widened
    expert slice and its f32 weight gradient are all the backward holds
    beside its outputs: 264 MB each at dbrx-132b's [6144, 10752], where the
    whole stack's would be 4.23 GB each.  The same arithmetic on the CPU
    and the card."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        # meta (the dry run) takes the card's product, not the CPU's f32
        # copies of the operands, which the card never makes
        if a.device.type in ("cuda", "meta"):
            mm = torch.bmm if a.dim() == 3 else torch.mm
            return mm(a, b, out_dtype=torch.float32)
        return torch.matmul(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need_a, need_b = ctx.needs_input_grad[:2]
        if a.dim() == 2:
            ga = (torch.matmul(g, b.float().mT).to(a.dtype) if need_a
                  else None)
            gb = (torch.matmul(a.float().mT, g).to(b.dtype) if need_b
                  else None)
            return ga, gb
        ga = torch.empty_like(a) if need_a else None
        gb = torch.empty_like(b) if need_b else None
        for e in range(a.shape[0]):
            # each assignment casts its f32 product once to the dtype
            if need_a:
                ga[e] = torch.mm(g[e], b[e].float().mT)
            if need_b:
                gb[e] = torch.mm(a[e].float().mT, g[e])
        return ga, gb


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D or batched 3-D) with the products of the activation-dtype
    operands summed in f32 and the result kept in f32 (the reference's
    `preferred_element_type=f32` with no cast back); f32 and f64 operands
    take the plain product and its autograd."""
    if a.dtype in (torch.float32, torch.float64):
        return torch.matmul(a, b)
    return MatmulF32.apply(a, b)


def gather_sum(y: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """y [E * C, D], slots [T, k] (E * C where an assignment was dropped)
    -> [T, D]: each token's k rows of y summed over k in order, in y's
    dtype, a dropped assignment reading a zero row."""
    y_pad = torch.cat([y, y.new_zeros(1, y.shape[1])])
    out = y_pad[slots[:, 0]]
    for j in range(1, slots.shape[1]):
        out = out + y_pad[slots[:, j]]
    return out


class Dispatch(torch.autograd.Function):
    """x [T, D] -> the capacity buffers' rows x_pad[buf_tok] [E * C, D]
    (row T of x_pad, an empty slot's, is zero).  Its backward sums each
    token's k slot gradients in k order through the inverse map `slots`
    (`gather_sum`), in the cotangent's dtype, x's, as the reference's
    transpose of the gather scatter-adds in x's dtype
    (`repro/models/moe.py:119-120`); an empty slot's gradient is read by
    no token."""

    @staticmethod
    def forward(ctx, x, buf_tok, slots):
        ctx.save_for_backward(slots)
        return torch.cat([x, x.new_zeros(1, x.shape[1])])[buf_tok]

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        return gather_sum(g, slots), None, None


def _top_k(scores: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest scores per row, best first, ties to the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route(logits: torch.Tensor, cfg
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits: [T, E] (f32) -> (weights [T, k], idx [T, k], aux loss)."""
    e = logits.shape[-1]
    k = cfg.moe_top_k
    if cfg.router_kind == "sigmoid":                    # deepseek-v3 style
        scores = torch.sigmoid(logits)
        w, idx = _top_k(scores, k)
        probs = scores / scores.sum(-1, keepdim=True).clamp_min(1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = _top_k(probs, k)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_i f_i * P_i
    f_i = F.one_hot(idx[:, 0], e).to(logits.dtype).mean(0)
    p_i = probs.mean(0)
    aux = e * (f_i * p_i).sum()
    return w, idx, aux


def _swiglu_grouped(xg, wg, wu, wd):
    """xg: [E, C, D]; wg / wu: [E, D, F]; wd: [E, F, D] -> [E, C, D] in
    xg's dtype."""
    h = (F.silu(_mm_f32(xg, wg)) * _mm_f32(xg, wu)).to(xg.dtype)
    return _mm_f32(h, wd).to(xg.dtype)


def _moe_body(x: torch.Tensor, p: MoE, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [T, D] -> (out [T, D] in x's dtype, aux loss)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = torch.matmul(f32(x), f32(p.router))
    weights, idx, aux = _route(logits, cfg)

    cap = max(1, int(math.ceil(cfg.capacity_factor * t * k / e)))
    expert_id = idx.reshape(-1)                                   # [T*k]
    onehot = F.one_hot(expert_id, e)                              # [T*k, E]
    pos = onehot.cumsum(0).gather(1, expert_id[:, None])[:, 0] - 1
    keep = pos < cap
    sentinel = e * cap
    slot = torch.where(keep, expert_id * cap + pos,
                       torch.full_like(pos, sentinel))
    token_id = torch.arange(t, device=x.device).repeat_interleave(k)
    buf_tok = torch.full((sentinel + 1,), t, dtype=torch.long,
                         device=x.device)
    buf_tok[slot] = token_id          # writes to the sentinel are dropped
    buf_w = torch.zeros(sentinel + 1, dtype=weights.dtype, device=x.device)
    buf_w[slot] = weights.reshape(-1)
    buf_tok, buf_w = buf_tok[:-1], buf_w[:-1]
    for fn in _OBSERVERS:
        fn(idx, keep.view(t, k), cap)

    slots = slot.view(t, k)
    xg = Dispatch.apply(x, buf_tok, slots).view(e, cap, d)
    y = _swiglu_grouped(xg, p.w_gate, p.w_up, p.w_down).view(e * cap, d)
    y = y * buf_w[:, None].to(y.dtype)
    # combine: each token's k slot outputs (a zero row where dropped),
    # summed over k in order in f32
    out = gather_sum(f32(y), slots)

    if p.shared is not None:
        s = p.shared
        h = (F.silu(_mm_f32(x, s.w_gate)) * _mm_f32(x, s.w_up)).to(x.dtype)
        out = out + _mm_f32(h, s.w_down)
    return out.to(x.dtype), aux


def moe_apply(p: MoE, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux loss scalar)."""
    b, s, d = x.shape
    out, aux = _moe_body(x.reshape(b * s, d), p, cfg)
    return out.view(b, s, d), aux

