"""CUDA Mamba2 SSD scan and its gradient (`csrc/mamba2_ssd.cu`), bound
through a plain C interface.

Replaces the Pallas kernel `repro/kernels/mamba2_ssd.py` (`mamba2_ssd` /
`_ssd_kernel`) and the D-skip term its wrapper adds.  The library is
compiled with `nvcc` for `sm_90a` at first use and loaded with `ctypes`
(`_build.Library`).  The wrapper takes contiguous CUDA tensors (x, B, C in
one type, float32 or bfloat16; d in float32 or x's type; dt, A and the
state in float32) and raises on anything else; it allocates y in x's type,
the final state and the kernel's scratch (each 64-step chunk's [P, N]
state and its total log decay) with `torch.empty`, makes one call that
launches the kernel's three phases on `torch.cuda.current_stream()`
(chunk states, the scan over chunks, the output), and raises when a
launch reports an error.  Nothing else runs on the device: the kernel
adds the D-skip in f32 and rounds y to x's type once, as the plain
version does.  With `return_states` it also returns the chunk states,
which the backward reads.

The backward (`mamba2_ssd_bwd`) replaces no Pallas kernel: the reference
differentiates its chunked SSD with XLA (`repro/kernels/ref.py:310`,
`mamba2_ssd_chunked`).  It is four kernels per call: the increments of
the state's gradient per chunk, a reverse scan over chunks, one block per
(chunk, b, h) for dx, ddt and per-head partials of dB, dC, da and dD, and
a fixed-order reduction of those partials (no atomics: the same inputs
give the same bits).  Its plain version is `ref.mamba2_ssd_bwd`.
`Mamba2SSD` is the `torch.autograd.Function` that joins the two, and the
only route to a gradient: the raw `mamba2_ssd` refuses one.
`launches` counts the forward's calls under `mamba2_ssd` and the
backward's under `mamba2_ssd_bwd`, one per call.  What bounds the kernels
on the H100, and what their design does about it, is written beside them
in the CUDA source.

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba2_ssd.cu"
MAX_STATE = 128           # kMaxState in the CUDA source
CHUNK = 64                # kC in the CUDA source: steps per chunk
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = (torch.float32,)

# the backward's four kernels, in launch order
BWD_KERNELS = ("ssd_bwd_state_inc", "ssd_bwd_state_scan",
               "ssd_bwd_chunk_grad", "ssd_bwd_reduce")

launches = _build.Launches("mamba2_ssd", "mamba2_ssd_bwd")
reset_launches = launches.reset


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mamba2_ssd_fwd.argtypes = [p] * 11 + [i] * 7 + [p]
    lib.mamba2_ssd_fwd.restype = i
    lib.mamba2_ssd_bwd.argtypes = [p] * 17 + [i] * 7 + [p]
    lib.mamba2_ssd_bwd.restype = i
    lib.mamba2_ssd_bwd_scratch.argtypes = [i] * 5
    lib.mamba2_ssd_bwd_scratch.restype = ctypes.c_size_t
    lib.mamba2_ssd_bwd_blocks_per_sm.argtypes = [i, i, p]
    lib.mamba2_ssd_bwd_blocks_per_sm.restype = i
    for fn in (lib.mamba2_ssd_max_state, lib.mamba2_ssd_chunk):
        fn.argtypes = []
        fn.restype = i
    if (lib.mamba2_ssd_max_state(), lib.mamba2_ssd_chunk()) != (MAX_STATE,
                                                               CHUNK):
        raise RuntimeError("kernel's state-width limit or chunk length "
                           "disagrees with the wrapper's")


_LIB = _build.Library(SOURCE, _declare)
load = _LIB.load
build_info = _LIB.info


def scratch(b: int, s: int, h: int, p: int, n: int, dev
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch, uninitialised: each chunk's state increment,
    then its starting state, [B, H, NC, P, N], and its total log decay
    [B, H, NC], f32, NC = ceil(S / 64)."""
    nc = -(-s // CHUNK)
    return (torch.empty((b, h, nc, p, n), dtype=torch.float32, device=dev),
            torch.empty((b, h, nc), dtype=torch.float32, device=dev))


def _check(x, dt, a, b_in, c_in, d, state) -> Tuple[int, ...]:
    """Raise unless the forward's operands are ones the kernels take;
    returns (B, S, H, P, N)."""
    _build.check_operand("x", x, 4, tuple(DTYPES))
    _build.check_operand("dt", dt, 3, _F32)
    _build.check_operand("a", a, 1, _F32)
    _build.check_operand("b_in", b_in, 3, (x.dtype,))
    _build.check_operand("c_in", c_in, 3, (x.dtype,))
    _build.check_operand("d", d, 1,
                      tuple(dict.fromkeys((torch.float32, x.dtype))))
    tensors = [x, dt, a, b_in, c_in, d]
    if state is not None:
        _build.check_operand("state", state, 4, _F32)
        tensors.append(state)
    _build.same_device(*tensors)
    bb, s, h, p = x.shape
    n = b_in.shape[2]
    if (tuple(dt.shape) != (bb, s, h) or tuple(a.shape) != (h,)
            or tuple(b_in.shape) != (bb, s, n) or c_in.shape != b_in.shape
            or tuple(d.shape) != (h,)
            or (state is not None
                and tuple(state.shape) != (bb, h, p, n))):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b_in.shape)}, c "
            f"{tuple(c_in.shape)}, d {tuple(d.shape)}, state "
            f"{None if state is None else tuple(state.shape)}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state width {n} outside 1..{MAX_STATE}")
    if s < 1 or p < 1:
        raise ValueError(f"empty operands: S = {s}, P = {p}")
    if bb * h > 65535:
        raise ValueError(f"B*H = {bb * h} exceeds the grid's 65535")
    return bb, s, h, p, n


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b_in: torch.Tensor, c_in: torch.Tensor, d: torch.Tensor,
               state: Optional[torch.Tensor] = None, *, chunk: int = 128,
               return_states: bool = False):
    """x: [B,S,H,P]; dt: [B,S,H] f32; a: [H] f32 (negative); b, c: [B,S,N]
    in x's dtype; d: [H] f32 or in x's dtype; state: [B,H,P,N] f32 or None
    (zeros).  Returns (y [B,S,H,P] in x's dtype, final state [B,H,P,N]
    f32), and with `return_states` also each 64-step chunk's starting
    state [B,H,NC,P,N] f32, which the backward takes.

    `chunk` is the reference's chunk length; the kernel cuts the sequence
    into chunks of its own (64 steps), and the result does not depend on
    the length beyond rounding, so it only has to be positive."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    _build.refuse_grad(
        "mamba2_ssd", x, dt, a, b_in, c_in, d, state,
        reason="its output carries no grad_fn; a gradient goes through "
               "`Mamba2SSD` (ops.mamba2_ssd takes it under grad)")
    bb, s, h, p, n = _check(x, dt, a, b_in, c_in, d, state)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    final = torch.empty((bb, h, p, n), dtype=torch.float32, device=x.device)
    ds, clast = scratch(bb, s, h, p, n, x.device)
    if _build.on_meta(x):
        _build.record("mamba2_ssd", cost(x, b_in, state), x, b_in)
        return (y, final, ds) if return_states else (y, final)
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mamba2_ssd_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), d.data_ptr(),
            None if state is None else state.data_ptr(), y.data_ptr(),
            final.data_ptr(), ds.data_ptr(), clast.data_ptr(), bb, s, h, p,
            n, DTYPES[x.dtype], DTYPES[d.dtype], stream)
    _build.raise_on(err, "mamba2_ssd")
    launches.count("mamba2_ssd")
    return (y, final, ds) if return_states else (y, final)


def cost(x: torch.Tensor, b_in: torch.Tensor,
         state: Optional[torch.Tensor]) -> dict:
    """The least work of one forward call: {"flops": {type: n}, "bytes":
    n}.  Bytes: x, dt, B, C, A, D and the state read once, y and the
    final state written once.  Operations: the recurrence's 5 f32
    operations per (t, h, p, n) (decay, input product, add, and the C .
    state multiply-add), the least the function needs, on the CUDA cores:
    the state and decays are f32 in the reference."""
    bb, s, h, p = x.shape
    n = b_in.shape[2]
    elem = x.element_size()
    n_bytes = (2 * elem * x.numel() + 4 * bb * s * h + 2 * elem * b_in.numel()
               + 8 * h + 4 * bb * h * p * n * (2 if state is not None else 1))
    return {"flops": {"float32": 5 * bb * s * h * p * n}, "bytes": n_bytes}


def bwd_cost(x: torch.Tensor, b_in: torch.Tensor,
             state: Optional[torch.Tensor],
             dstate_out: Optional[torch.Tensor]) -> dict:
    """The least work of one backward call, as `cost`.  Bytes: x, dy, B
    and C in x's type, dt, a, D, and the state and its gradient where
    given, read once; dx, dB, dC in x's type, ddt, da, dD and dstate
    written once.  Operations: the least the gradient of the sequential
    recurrence needs, 11 f32 operations per (t, h, p, n): the state's
    gradient dS_t = e^{la_t} dS_{t+1} + dy_t C_t^T (a multiply and a
    multiply-add), and one multiply-add each for dC (S_t^T dy_t), dxdt
    (dS_t B_t), dB (dS_t^T xdt_t) and the decay's gradient (<dS_t,
    S_{t-1}>), not counting the states S_t it reads, on the CUDA cores."""
    bb, s, h, p = x.shape
    n = b_in.shape[2]
    elem = x.element_size()
    state_rw = (state is not None) + (dstate_out is not None)
    n_bytes = (3 * elem * x.numel() + 2 * 4 * bb * s * h
               + 4 * elem * b_in.numel() + 4 * 4 * h
               + 4 * bb * h * p * n * (state_rw + (state is not None)))
    return {"flops": {"float32": 11 * bb * s * h * p * n}, "bytes": n_bytes}


def scratch_floats(b: int, s: int, h: int, p: int, n: int) -> int:
    """`mamba2_ssd_bwd_scratch` of the CUDA source, in Python: the
    state's gradient per chunk [B, H, NC, P, N], the chunks' total log
    decays [B, H, NC], the per-head partials of dB and dC [B, H, S, N]
    each and those of da and dD [B, H, NC] each."""
    nc, nbh = -(-s // CHUNK), b * h
    return nbh * nc * p * n + nbh * nc + 2 * nbh * s * n + 2 * nbh * nc


def bwd_scratch(b: int, s: int, h: int, p: int, n: int) -> int:
    """Floats of f32 scratch the backward allocates, as the CUDA source
    lays it out: the state's gradient per chunk, the chunks' total log
    decays, and the per-head partials of dB, dC, da and dD."""
    return load().mamba2_ssd_bwd_scratch(b, s, h, p, n)


def bwd_blocks_per_sm(dtype: torch.dtype, n: int) -> dict:
    """How many blocks of each of the backward's four kernels one SM of
    the current card holds at once (CUDA's occupancy calculator, at the
    shared memory a call with state width n gives each), by kernel name."""
    if dtype not in DTYPES or not 1 <= n <= MAX_STATE:
        raise ValueError(f"no backward instance for {dtype}, N = {n}")
    blocks = (ctypes.c_int * len(BWD_KERNELS))()
    _build.raise_on(load().mamba2_ssd_bwd_blocks_per_sm(DTYPES[dtype], n,
                                                        blocks),
                    "mamba2_ssd_bwd_blocks_per_sm")
    return dict(zip(BWD_KERNELS, blocks))


def mamba2_ssd_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_in: torch.Tensor, c_in: torch.Tensor, d: torch.Tensor,
                   state: Optional[torch.Tensor], dy: torch.Tensor,
                   dstate_out: Optional[torch.Tensor], *,
                   states: torch.Tensor):
    """The gradient (dx, ddt, da, db, dc, dd, dstate) of `mamba2_ssd(x,
    dt, a, b_in, c_in, d, state)` for the output gradients dy ([B,S,H,P]
    in x's type) and dstate_out ([B,H,P,N] f32, or None for zeros), given
    that call's chunk states (`return_states=True`).  Each gradient comes
    in its operand's type; dstate is None when state is."""
    bb, s, h, p, n = _check(x, dt, a, b_in, c_in, d, state)
    _build.check_operand("dy", dy, 4, (x.dtype,))
    if dy.shape != x.shape:
        raise ValueError(f"dy: expected {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    nc = -(-s // CHUNK)
    _build.check_operand("states", states, 5, _F32)
    if tuple(states.shape) != (bb, h, nc, p, n):
        raise ValueError(f"states: expected {(bb, h, nc, p, n)}, got "
                         f"{tuple(states.shape)}")
    tensors = [x, dy, states]
    if dstate_out is not None:
        _build.check_operand("dstate_out", dstate_out, 4, _F32)
        if tuple(dstate_out.shape) != (bb, h, p, n):
            raise ValueError(f"dstate_out: expected {(bb, h, p, n)}, got "
                             f"{tuple(dstate_out.shape)}")
        tensors.append(dstate_out)
    _build.same_device(*tensors)
    dx, ddt, da, db, dc, dd = (torch.empty_like(t)
                               for t in (x, dt, a, b_in, c_in, d))
    dstate = None if state is None else torch.empty_like(state)
    if _build.on_meta(x):
        work = torch.empty(scratch_floats(bb, s, h, p, n),
                           dtype=torch.float32, device=x.device)
        _build.record("mamba2_ssd_bwd",
                      bwd_cost(x, b_in, state, dstate_out), x, b_in)
        return dx, ddt, da, db, dc, dd, dstate
    work = torch.empty(bwd_scratch(bb, s, h, p, n), dtype=torch.float32,
                       device=x.device)
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mamba2_ssd_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), d.data_ptr(), dy.data_ptr(), states.data_ptr(),
            None if dstate_out is None else dstate_out.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
            dc.data_ptr(), dd.data_ptr(),
            None if dstate is None else dstate.data_ptr(), work.data_ptr(),
            bb, s, h, p, n, DTYPES[x.dtype], DTYPES[d.dtype], stream)
    _build.raise_on(err, "mamba2_ssd_bwd")
    launches.count("mamba2_ssd_bwd")
    return dx, ddt, da, db, dc, dd, dstate


class Mamba2SSD(torch.autograd.Function):
    """`mamba2_ssd` with its gradient through `mamba2_ssd_bwd`: the
    forward asks for the chunk states and saves the operands with them.
    `ops.mamba2_ssd` takes this route only when a gradient is being
    recorded, so a forward without one launches as before and saves
    nothing.  Either output's gradient may be None (a loss that reads y
    alone): y's is then zeros, the final state's is passed as None."""

    @staticmethod
    def forward(ctx, x, dt, a, b_in, c_in, d, state):
        y, final, states = mamba2_ssd(x, dt, a, b_in, c_in, d, state,
                                      return_states=True)
        ctx.save_for_backward(x, dt, a, b_in, c_in, d, state, states)
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, b_in, c_in, d, state, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        return mamba2_ssd_bwd(
            x, dt, a, b_in, c_in, d, state, dy,
            None if dfinal is None else dfinal.contiguous(), states=states)
