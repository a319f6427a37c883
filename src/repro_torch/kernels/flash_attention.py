"""CUDA causal GQA attention, forward and backward
(`csrc/flash_attention.cu`), bound through a plain C interface.

Replaces the Pallas kernel `repro/kernels/flash_attention.py`
(`flash_attention` / `_attn_kernel`).  The library is compiled with
`nvcc` for `sm_90a` at first use and loaded with `ctypes`
(`_build.Library`).  The wrapper takes contiguous CUDA tensors of one
type, float32 or bfloat16, and raises on anything else; it launches on
`torch.cuda.current_stream()`, allocates its output with `torch.empty`
and raises when the launch reports an error.  `launches` counts the
forward's launches under `flash_attention` and the backward's under
`flash_attention_bwd` (one per call; a backward call is three kernels,
or four where `bwd_splits` is above 1).

The source has two routes, picked by the type.  bfloat16 runs the
products on the tensor cores (`mma.sync` bf16 tiles with f32 sums,
operand tiles copied by `cp.async` one tile ahead).  Its forward rounds
each probability to bf16 before the P V product, and its backward rounds
P and dS to bf16 before the three products that take them, which the
reference does not: at most 2^-9 relative each.  float32 runs its
products in f32 on the CUDA cores, as the reference does (no TF32).
What bounds each route on the H100, and what its design does about it,
is written beside the kernels in the CUDA source.

The backward (`flash_attention_bwd`) replaces no Pallas kernel: it
computes what the reference's custom VJP `_flash_bwd`
(`repro/kernels/ref.py:142`) computes, from the forward's output and its
row log-sum-exp (`flash_attention(..., return_lse=True)`), with a fixed
summation order (no atomics).  On the bf16 route a kv head's group of
query heads may be split across G blocks whose f32 partials a fourth
kernel sums in index order (`bwd_splits`).  `FlashAttention` is the
`torch.autograd.Function` that joins the two.

On `meta` tensors (the dry run, `repro_torch.launch.cost`) both wrappers
check their operands as on the card, allocate what they allocate there
(the output and log-sum-exp; the gradients and the f32 scratch), record
one call with its `cost` / `bwd_cost` and launch nothing.  `bwd_splits`
and `bwd_scratch` then answer from `splits_rule` / `scratch_floats`, the
Python twins of the source's rules.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256        # kMaxHeadDim in the CUDA source
SMS = 132                 # kSms in the CUDA source: SMs of the H100 SXM
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.Launches("flash_attention", "flash_attention_bwd")
reset_launches = launches.reset


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 9 + [p]
    lib.flash_attention_bwd.restype = i
    lib.flash_attention_bwd_splits.argtypes = [i] * 7
    lib.flash_attention_bwd_splits.restype = i
    lib.flash_attention_bwd_scratch.argtypes = [i] * 8
    lib.flash_attention_bwd_scratch.restype = ctypes.c_size_t
    lib.flash_attention_bf16_occupancy.argtypes = [i, i, p, p]
    lib.flash_attention_bf16_occupancy.restype = i
    lib.flash_attention_max_head_dim.argtypes = []
    lib.flash_attention_max_head_dim.restype = i
    if lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("kernel's head-dim limit disagrees with the "
                           "wrapper's")


_LIB = _build.Library(SOURCE, _declare)
load = _LIB.load
build_info = _LIB.info


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    """Raise unless q, k, v are operands the kernels take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(name, t, 4, tuple(DTYPES))
    _build.same_device(q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, sq, h, dh = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape[0] != b or k.shape[3] != dh
            or tuple(v.shape[:3]) != (b, skv, hkv)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims {dh}, {dv} outside 1..{MAX_HEAD_DIM}")
    if sq < 1 or skv < 1 or (causal and sq > skv):
        raise ValueError(f"need 1 <= Sq, 1 <= Skv and, with causal, "
                         f"Sq <= Skv; got Sq {sq}, Skv {skv}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's 65535")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """q: [B,Sq,H,Dh]; k: [B,Skv,Hkv,Dh]; v: [B,Skv,Hkv,Dv] -> [B,Sq,H,Dv]
    in q's dtype, with Dh and Dv each in 1..256.  Query head h reads kv
    head h // (H / Hkv); with `causal` the mask's diagonal is offset by
    Skv - Sq (so Sq <= Skv).  Softmax statistics and the accumulator are
    f32 on both routes; the output is rounded once.  With `return_lse`,
    returns (out, lse) with lse [B,H,Sq] f32, each row's log-sum-exp of
    the scaled scores, which the backward takes."""
    _check(q, k, v, causal)
    b, sq, h, _ = q.shape
    skv, hkv, dh, dv = k.shape[1], k.shape[2], q.shape[3], v.shape[3]
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if _build.on_meta(q):
        _build.record("flash_attention", cost(q, k, v, causal=causal),
                      q, k, v)
        return (out, lse) if return_lse else out
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, sq, skv, h, hkv, dh,
            dv, int(causal), DTYPES[q.dtype], stream)
    _build.raise_on(err, "flash_attention")
    launches.count("flash_attention")
    return (out, lse) if return_lse else out


def causal_pairs(sq: int, skv: int, causal: bool = True) -> int:
    """The (query, key) pairs a call computes per (batch, head): all Sq
    Skv of them, or with `causal` those with key <= query + Skv - Sq (row
    r sees min(Skv, r + Skv - Sq + 1) keys; with Sq <= Skv, the minimum is
    always the second), summed in closed form."""
    if not causal:
        return sq * skv
    return sq * (skv - sq + 1) + sq * (sq - 1) // 2


def _peak_type(q: torch.Tensor) -> str:
    # the products' type: bf16 on the tensor cores, f32 on the CUDA cores
    return "bfloat16" if q.dtype == torch.bfloat16 else "float32"


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True) -> dict:
    """The least work of one forward call: {"flops": {type: n}, "bytes":
    n}.  Bytes: q, k, v read once and the output written once.
    Operations: 2 (Dh + Dv) per visible (query, key) pair, at the
    products' type (bf16 operands on the tensor cores, f32 on the CUDA
    cores: the port allows no TF32)."""
    b, sq, h, dh = q.shape
    skv, dv = k.shape[1], v.shape[3]
    elem = q.element_size()
    n_bytes = elem * (q.numel() + k.numel() + v.numel() + b * sq * h * dv)
    flops = b * h * causal_pairs(sq, skv, causal) * 2 * (dh + dv)
    return {"flops": {_peak_type(q): flops}, "bytes": n_bytes}


def bwd_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True) -> dict:
    """The least work of one backward call, as `cost`.  Bytes: q, k, v,
    the output and its gradient read once each in the operands' type, the
    f32 log-sum-exp read once, dq, dk and dv written once.  Operations:
    2 (3 Dh + 2 Dv) per visible (query, key) pair (S recomputed once,
    dP = dO V^T, dV, dK and dQ), at the operands' type."""
    b, sq, h, dh = q.shape
    skv, dv = k.shape[1], v.shape[3]
    elem = q.element_size()
    n_bytes = (elem * (2 * (q.numel() + k.numel() + v.numel())
                       + 2 * b * sq * h * dv) + 4 * b * h * sq)
    flops = b * h * causal_pairs(sq, skv, causal) * 2 * (3 * dh + 2 * dv)
    return {"flops": {_peak_type(q): flops}, "bytes": n_bytes}


def _bwd_tile_rows(d: int) -> int:
    # bwd_tile_rows in the CUDA source
    return 32 if d > 128 else 64


def splits_rule(b: int, skv: int, h: int, hkv: int, dh: int, dv: int,
                dtype: torch.dtype) -> int:
    """`flash_attention_bwd_splits` of the CUDA source, in Python: 1 on
    the f32 route; on the bf16 route the least divisor G of the group H /
    Hkv whose dk/dv blocks, G x ceil(Skv / rows) x B x Hkv, fill two per
    SM, else the whole group."""
    if hkv < 1 or h % hkv or dtype != torch.bfloat16:
        return 1
    group = h // hkv
    rows = _bwd_tile_rows((max(dh, dv) + 15) // 16 * 16)
    blocks = -(-skv // rows) * b * hkv
    for g in range(1, group):
        if group % g == 0 and blocks * g >= 2 * SMS:
            return g
    return group


def scratch_floats(b: int, sq: int, skv: int, h: int, hkv: int, dh: int,
                   dv: int, dtype: torch.dtype) -> int:
    """`flash_attention_bwd_scratch` of the CUDA source, in Python: D,
    B H Sq floats, then where G > 1 the G dk/dv partials [G, B, Skv, Hkv,
    Dh + Dv]."""
    g = splits_rule(b, skv, h, hkv, dh, dv, dtype)
    return b * h * sq + (g * b * skv * hkv * (dh + dv) if g > 1 else 0)


def bwd_splits(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """G: the blocks over which the backward's dk/dv kernel splits each kv
    head's group of query heads for these operands (1 on the f32 route;
    the rule is stated in the CUDA source, and for `meta` operands read
    from its twin `splits_rule`).  Where G > 1 a fourth kernel sums the
    blocks' partials."""
    b, _, h, dh = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if _build.on_meta(q):
        return splits_rule(b, skv, h, hkv, dh, dv, q.dtype)
    return load().flash_attention_bwd_splits(b, skv, h, hkv, dh, dv,
                                             DTYPES[q.dtype])


BF16_KERNELS = ("flash_attention_bf16_kernel", "flash_attention_bwd_dq_tc",
                "flash_attention_bwd_dkv_tc")


def bf16_occupancy(dh: int, dv: int) -> dict:
    """For the bf16 route at head widths dh, dv (one template instance per
    padded width): how many blocks of its forward, dq and dk/dv kernels
    one SM of the current card holds at once (CUDA's occupancy
    calculator) and the dynamic shared memory each is launched with, by
    kernel name: {name: {"blocks_per_sm", "smem_bytes"}}."""
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"no bf16 instance for Dh {dh}, Dv {dv}")
    blocks = (ctypes.c_int * len(BF16_KERNELS))()
    smem = (ctypes.c_int * len(BF16_KERNELS))()
    _build.raise_on(load().flash_attention_bf16_occupancy(dh, dv, blocks,
                                                          smem),
                    "flash_attention_bf16_occupancy")
    return {name: {"blocks_per_sm": b, "smem_bytes": m}
            for name, b, m in zip(BF16_KERNELS, blocks, smem)}


def bwd_scratch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Floats of f32 scratch the backward allocates for these operands,
    as the CUDA source lays it out: D = rowsum(dO O), then the G dk/dv
    partials where G > 1 (for `meta` operands, its twin
    `scratch_floats`)."""
    b, sq, h, dh = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if _build.on_meta(q):
        return scratch_floats(b, sq, skv, h, hkv, dh, dv, q.dtype)
    return load().flash_attention_bwd_scratch(b, sq, skv, h, hkv, dh, dv,
                                              DTYPES[q.dtype])


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient (dq, dk, dv) in q's dtype of `flash_attention(q, k, v,
    causal=causal)` for the output gradient `dout`, given that call's
    output `out` and log-sum-exp `lse` ([B,H,Sq] f32).  Shapes and types
    as the forward's; `out` and `dout` are [B,Sq,H,Dv] in q's dtype."""
    _check(q, k, v, causal)
    b, sq, h, dh = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("out", out), ("dout", dout)):
        _build.check_operand(name, t, 4, (q.dtype,))
        if tuple(t.shape) != (b, sq, h, dv):
            raise ValueError(f"{name}: expected {(b, sq, h, dv)}, got "
                             f"{tuple(t.shape)}")
    _build.check_operand("lse", lse, 3, (torch.float32,))
    if tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"lse: expected {(b, h, sq)}, got "
                         f"{tuple(lse.shape)}")
    _build.same_device(q, out, lse, dout)
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    dd = torch.empty(bwd_scratch(q, k, v), dtype=torch.float32,
                     device=q.device)
    if _build.on_meta(q):
        _build.record("flash_attention_bwd",
                      bwd_cost(q, k, v, causal=causal), q, k, v)
        return dq, dk, dvv
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dvv.data_ptr(), dd.data_ptr(), b, sq, skv, h, hkv, dh, dv,
            int(causal), DTYPES[q.dtype], stream)
    _build.raise_on(err, "flash_attention_bwd")
    launches.count("flash_attention_bwd")
    return dq, dk, dvv


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with its gradient through `flash_attention_bwd`:
    the forward asks for the log-sum-exp and saves q, k, v, the output and
    the log-sum-exp.  `ops.flash_attention` takes this route only when a
    gradient is being recorded, so a forward without one launches as
    before and saves nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None
