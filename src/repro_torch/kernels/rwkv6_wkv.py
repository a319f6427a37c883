"""CUDA RWKV6 WKV recurrence (`csrc/rwkv6_wkv.cu`), bound through a plain
C interface.

Replaces the Pallas kernel `repro/kernels/rwkv6_scan.py` (`rwkv6_wkv` /
`_wkv_kernel`) and the bonus term its wrapper adds.  The library is
compiled with `nvcc` for `sm_90a` at first use and loaded with `ctypes`
(`_build.Library`).  The wrapper takes contiguous CUDA tensors (r, k, v
and u in one type, float32 or bfloat16; w and the state in float32) and
raises on anything else; it allocates its outputs and the kernel's
scratch (each 64-step chunk's [K, V] state and its total log2 decay) with
`torch.empty`, makes one call that launches the kernel's three phases on
`torch.cuda.current_stream()` (chunk states, the scan over chunks, the
output), and raises when a launch reports an error.  The kernel adds the
bonus in f32 and rounds the output to r's type once, as the plain version
does.  With `return_states` it also returns the chunk states, which the
backward reads.

The backward (`rwkv6_wkv_bwd`) replaces no Pallas kernel: the reference
differentiates the WKV with XLA (`repro/kernels/ops.py` `rwkv6_wkv`).  It
is four kernels per call: the increments of the state's gradient per
chunk, a reverse scan over chunks, one block per (chunk, b, h) for the
terms that take the chunk's state and its gradient and then the rest of
dr, dk, dv and dw and a per-(b, chunk) partial of du, and a fixed-order
reduction of those partials (no atomics: the same inputs give the same
bits).  Every decay in it is a product of max(w, 1e-30)
over its own steps: it takes no exponential or logarithm.  It takes K,
V <= 64.  Its plain version is `ref.rwkv6_wkv_bwd`;
`bwd_blocks_per_sm` reads how many blocks of each kernel an SM holds.
`RWKV6WKV` is the `torch.autograd.Function` that joins the two, and the
only route to a gradient: the raw `rwkv6_wkv` refuses one.  `launches`
counts the forward's calls under `rwkv6_wkv` and the backward's under
`rwkv6_wkv_bwd`, one per call (their kernels count once).  What bounds
the kernels on the H100, and what their design does about it, is written
beside them in the CUDA source.

On `meta` tensors (the dry run, `repro_torch.launch.cost`) both wrappers
check their operands as on the card, allocate what they allocate there
(outputs and scratch; the backward's scratch sized by `scratch_floats`,
the Python twin of the source's rule), record one call with its `cost` /
`bwd_cost` and launch nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_wkv.cu"
MAX_K = 128               # kMaxK in the CUDA source
MAX_KV_BWD = 64           # kBK in the CUDA source: the backward's K, V limit
CHUNK = 64                # kC in the CUDA source: steps per chunk
BWD_TERMS = 3 * CHUNK * MAX_KV_BWD   # kTerms in the CUDA source
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = (torch.float32,)

# the backward's four kernels, in launch order
BWD_KERNELS = ("wkv_bwd_state_inc", "wkv_bwd_state_scan",
               "wkv_bwd_chunk_grad", "wkv_bwd_reduce")

launches = _build.Launches("rwkv6_wkv", "rwkv6_wkv_bwd")
reset_launches = launches.reset


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_wkv_fwd.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.rwkv6_wkv_fwd.restype = i
    lib.rwkv6_wkv_bwd.argtypes = [p] * 15 + [i] * 6 + [p]
    lib.rwkv6_wkv_bwd.restype = i
    lib.rwkv6_wkv_bwd_scratch.argtypes = [i] * 5
    lib.rwkv6_wkv_bwd_scratch.restype = ctypes.c_size_t
    lib.rwkv6_wkv_bwd_blocks_per_sm.argtypes = [i, i, p]
    lib.rwkv6_wkv_bwd_blocks_per_sm.restype = i
    for fn in (lib.rwkv6_wkv_max_k, lib.rwkv6_wkv_chunk,
               lib.rwkv6_wkv_bwd_max_kv):
        fn.argtypes = []
        fn.restype = i
    if (lib.rwkv6_wkv_max_k(), lib.rwkv6_wkv_chunk(),
            lib.rwkv6_wkv_bwd_max_kv()) != (MAX_K, CHUNK, MAX_KV_BWD):
        raise RuntimeError("kernel's key-width limits or chunk length "
                           "disagree with the wrapper's")


_LIB = _build.Library(SOURCE, _declare)
load = _LIB.load
build_info = _LIB.info


def scratch(b: int, s: int, h: int, kd: int, vd: int, dev
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch, uninitialised: each chunk's state increment,
    then its starting state, [B, H, NC, K, V], and its total log2 decay
    [B, H, NC, K], f32, NC = ceil(S / 64)."""
    nc = -(-s // CHUNK)
    return (torch.empty((b, h, nc, kd, vd), dtype=torch.float32, device=dev),
            torch.empty((b, h, nc, kd), dtype=torch.float32, device=dev))


def _check(r, k, v, w, u, state) -> Tuple[int, ...]:
    """Raise unless the forward's operands are ones the kernels take;
    returns (B, S, H, K, V)."""
    _build.check_operand("r", r, 4, tuple(DTYPES))
    for name, t in (("k", k), ("v", v)):
        _build.check_operand(name, t, 4, (r.dtype,))
    _build.check_operand("w", w, 4, _F32)
    _build.check_operand("u", u, 2, (r.dtype,))
    tensors = [r, k, v, w, u]
    if state is not None:
        _build.check_operand("state", state, 4, _F32)
        tensors.append(state)
    _build.same_device(*tensors)
    b, s, h, kd = r.shape
    vd = v.shape[3]
    if (k.shape != r.shape or w.shape != r.shape
            or tuple(v.shape[:3]) != (b, s, h) or tuple(u.shape) != (h, kd)
            or (state is not None
                and tuple(state.shape) != (b, h, kd, vd))):
        raise ValueError(
            f"shape mismatch: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, "
            f"state {None if state is None else tuple(state.shape)}")
    if not 1 <= kd <= MAX_K:
        raise ValueError(f"key width {kd} outside 1..{MAX_K}")
    if s < 1 or vd < 1:
        raise ValueError(f"empty operands: S = {s}, V = {vd}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's 65535")
    return b, s, h, kd, vd


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor] = None, *, chunk: int = 64,
              return_states: bool = False):
    """r, k: [B,S,H,K]; v: [B,S,H,V] in r's dtype; w: [B,S,H,K] f32;
    u: [H,K] in r's dtype; state: [B,H,K,V] f32 or None (zeros).  Returns
    (out [B,S,H,V] in r's dtype, final state [B,H,K,V] f32), and with
    `return_states` also each 64-step chunk's starting state
    [B,H,NC,K,V] f32, which the backward takes.

    `chunk` is the reference's chunk length; the kernel cuts the sequence
    into chunks of its own (64 steps), and the result does not depend on
    the length beyond rounding, so it only has to be positive."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    _build.refuse_grad(
        "rwkv6_wkv", r, k, v, w, u, state,
        reason="its output carries no grad_fn; a gradient goes through "
               "`RWKV6WKV` (ops.rwkv6_wkv takes it under grad)")
    b, s, h, kd, vd = _check(r, k, v, w, u, state)
    out = torch.empty(v.shape, dtype=r.dtype, device=r.device)
    final = torch.empty((b, h, kd, vd), dtype=torch.float32, device=r.device)
    ds, clast = scratch(b, s, h, kd, vd, r.device)
    if _build.on_meta(r):
        _build.record("rwkv6_wkv", cost(r, v, state), r, v)
        return (out, final, ds) if return_states else (out, final)
    lib = load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rwkv6_wkv_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            out.data_ptr(), final.data_ptr(), ds.data_ptr(),
            clast.data_ptr(), b, s, h, kd, vd, DTYPES[r.dtype], stream)
    _build.raise_on(err, "rwkv6_wkv")
    launches.count("rwkv6_wkv")
    # the scan leaves each chunk's starting state in ds
    return (out, final, ds) if return_states else (out, final)


def cost(r: torch.Tensor, v: torch.Tensor,
         state: Optional[torch.Tensor]) -> dict:
    """The least work of one forward call: {"flops": {type: n}, "bytes":
    n}.  Bytes: r, k, v, u in their type and w in f32 read once, the state
    read once when given, out written once in r's type and the final
    state in f32.  Operations: the recurrence's 5 f32 operations per (t,
    h, k, v) (decay, outer product, add, and the r . state multiply-add),
    the least the function needs, on the CUDA cores: the state and decays
    are f32 in the reference."""
    b, s, h, kd = r.shape
    vd = v.shape[3]
    elem = r.element_size()
    n_bytes = (elem * (2 * r.numel() + 2 * v.numel() + h * kd)
               + 4 * r.numel()
               + 4 * b * h * kd * vd * (2 if state is not None else 1))
    return {"flops": {"float32": 5 * b * s * h * kd * vd}, "bytes": n_bytes}


def bwd_cost(r: torch.Tensor, v: torch.Tensor,
             state: Optional[torch.Tensor],
             dstate_out: Optional[torch.Tensor]) -> dict:
    """The least work of one backward call, as `cost`.  Bytes: r, k, v, u
    and do in r's type and w in f32 read once, the state and its gradient
    read once where given; dr, dk, dv, du in r's type, dw and dstate in
    f32 written once.  Operations: the least the gradient of the
    sequential recurrence needs, 11 f32 operations per (t, h, k, v),
    counted as the SSD backward's are: the state's gradient dS_t = w_t o
    dS_{t+1} + r_t do_t^T (a multiply and a multiply-add), and one
    multiply-add each for dr (S_{t-1} do_t), dk (dS_t v_t), dv (dS_t^T
    k_t) and the decay's gradient (<dS_t, S_{t-1}>), not counting the
    states it reads, on the CUDA cores."""
    b, s, h, kd = r.shape
    vd = v.shape[3]
    elem = r.element_size()
    state_rw = (state is not None) + (dstate_out is not None)
    n_bytes = (elem * (4 * r.numel() + 3 * v.numel() + 2 * h * kd)
               + 2 * 4 * r.numel()
               + 4 * b * h * kd * vd * (state_rw + (state is not None)))
    return {"flops": {"float32": 11 * b * s * h * kd * vd}, "bytes": n_bytes}


def scratch_floats(b: int, s: int, h: int, kd: int, vd: int) -> int:
    """`rwkv6_wkv_bwd_scratch` of the CUDA source, in Python: per (b, h,
    chunk) the chunk gradients' S and G terms (three [64, 64] tiles) and
    a [64] vector, the state's gradient [K, V], the decay products [K]
    and the partials of du [K]."""
    nc = -(-s // CHUNK)
    return b * h * nc * (BWD_TERMS + MAX_KV_BWD + kd * vd + 2 * kd)


def bwd_scratch(b: int, s: int, h: int, kd: int, vd: int) -> int:
    """Floats of f32 scratch the backward allocates, as the CUDA source
    lays it out: the terms that take each chunk's state and its gradient
    (three [64, 64] tiles and a [64] vector per chunk), the state's
    gradient per chunk, the chunks' decay products, and the per-(b, chunk)
    partials of du."""
    return load().rwkv6_wkv_bwd_scratch(b, s, h, kd, vd)


def bwd_blocks_per_sm(dtype: torch.dtype, k: int) -> dict:
    """How many blocks of each of the backward's four kernels one SM of
    the current card holds at once (CUDA's occupancy calculator, at the
    shared memory each is launched with), by kernel name, for operands of
    `dtype` and key width k."""
    if dtype not in DTYPES or not 1 <= k <= MAX_KV_BWD:
        raise ValueError(f"no backward instance for {dtype}, K = {k}")
    blocks = (ctypes.c_int * len(BWD_KERNELS))()
    _build.raise_on(load().rwkv6_wkv_bwd_blocks_per_sm(DTYPES[dtype], k,
                                                       blocks),
                    "rwkv6_wkv_bwd_blocks_per_sm")
    return dict(zip(BWD_KERNELS, blocks))


def rwkv6_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  state: Optional[torch.Tensor], do: torch.Tensor,
                  dstate_out: Optional[torch.Tensor], *,
                  states: torch.Tensor):
    """The gradient (dr, dk, dv, dw, du, dstate) of `rwkv6_wkv(r, k, v, w,
    u, state)` for the output gradients do ([B,S,H,V] in r's type) and
    dstate_out ([B,H,K,V] f32, or None for zeros), given that call's chunk
    states (`return_states=True`).  Each gradient comes in its operand's
    type; dstate is None when state is.  K and V are at most 64."""
    b, s, h, kd, vd = _check(r, k, v, w, u, state)
    if kd > MAX_KV_BWD or vd > MAX_KV_BWD:
        raise ValueError(f"the backward takes K, V <= {MAX_KV_BWD}, got "
                         f"K = {kd}, V = {vd}")
    _build.check_operand("do", do, 4, (r.dtype,))
    if do.shape != v.shape:
        raise ValueError(f"do: expected {tuple(v.shape)}, got "
                         f"{tuple(do.shape)}")
    nc = -(-s // CHUNK)
    _build.check_operand("states", states, 5, _F32)
    if tuple(states.shape) != (b, h, nc, kd, vd):
        raise ValueError(f"states: expected {(b, h, nc, kd, vd)}, got "
                         f"{tuple(states.shape)}")
    tensors = [r, do, states]
    if dstate_out is not None:
        _build.check_operand("dstate_out", dstate_out, 4, _F32)
        if tuple(dstate_out.shape) != (b, h, kd, vd):
            raise ValueError(f"dstate_out: expected {(b, h, kd, vd)}, got "
                             f"{tuple(dstate_out.shape)}")
        tensors.append(dstate_out)
    _build.same_device(*tensors)
    dr, dk, dv, dw, du = (torch.empty_like(t) for t in (r, k, v, w, u))
    dstate = None if state is None else torch.empty_like(state)
    if _build.on_meta(r):
        work = torch.empty(scratch_floats(b, s, h, kd, vd),
                           dtype=torch.float32, device=r.device)
        _build.record("rwkv6_wkv_bwd",
                      bwd_cost(r, v, state, dstate_out), r, v)
        return dr, dk, dv, dw, du, dstate
    work = torch.empty(bwd_scratch(b, s, h, kd, vd), dtype=torch.float32,
                       device=r.device)
    lib = load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rwkv6_wkv_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), do.data_ptr(), states.data_ptr(),
            None if dstate_out is None else dstate_out.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), None if dstate is None else dstate.data_ptr(),
            work.data_ptr(), b, s, h, kd, vd, DTYPES[r.dtype], stream)
    _build.raise_on(err, "rwkv6_wkv_bwd")
    launches.count("rwkv6_wkv_bwd")
    return dr, dk, dv, dw, du, dstate


class RWKV6WKV(torch.autograd.Function):
    """`rwkv6_wkv` with its gradient through `rwkv6_wkv_bwd`: the forward
    asks for the chunk states and saves the operands with them.
    `ops.rwkv6_wkv` takes this route only when a gradient is being
    recorded, so a forward without one launches as before and saves
    nothing.  Either output's gradient may be None (a loss that reads out
    alone): out's is then zeros, the final state's is passed as None."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        out, final, states = rwkv6_wkv(r, k, v, w, u, state,
                                       return_states=True)
        ctx.save_for_backward(r, k, v, w, u, state, states)
        ctx.set_materialize_grads(False)
        return out, final

    @staticmethod
    def backward(ctx, dout, dfinal):
        r, k, v, w, u, state, states = ctx.saved_tensors
        dout = torch.zeros_like(v) if dout is None else dout.contiguous()
        return rwkv6_wkv_bwd(
            r, k, v, w, u, state, dout,
            None if dfinal is None else dfinal.contiguous(), states=states)
