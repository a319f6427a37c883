"""CUDA Mamba2 SSD scan (`csrc/mamba2_ssd.cu`), bound through a plain C
interface.

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
version does.  `launches` adds one per call (its three kernels count
once).  What bounds the kernel on the H100, and what its design does
about it, is written beside the kernel in the CUDA source.
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

launches = _build.Launches("mamba2_ssd")
reset_launches = launches.reset


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mamba2_ssd_fwd.argtypes = [p] * 11 + [i] * 7 + [p]
    lib.mamba2_ssd_fwd.restype = i
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


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b_in: torch.Tensor, c_in: torch.Tensor, d: torch.Tensor,
               state: Optional[torch.Tensor] = None, *, chunk: int = 128
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,H,P]; dt: [B,S,H] f32; a: [H] f32 (negative); b, c: [B,S,N]
    in x's dtype; d: [H] f32 or in x's dtype; state: [B,H,P,N] f32 or None
    (zeros).  Returns (y [B,S,H,P] in x's dtype, final state [B,H,P,N]
    f32).

    `chunk` is the reference's chunk length; the kernel cuts the sequence
    into chunks of its own (64 steps), and the result does not depend on
    the length beyond rounding, so it only has to be positive."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    _build.refuse_grad("mamba2_ssd", x, dt, a, b_in, c_in, d, state)
    _build.check_cuda("x", x, 4, tuple(DTYPES))
    _build.check_cuda("dt", dt, 3, _F32)
    _build.check_cuda("a", a, 1, _F32)
    _build.check_cuda("b_in", b_in, 3, (x.dtype,))
    _build.check_cuda("c_in", c_in, 3, (x.dtype,))
    _build.check_cuda("d", d, 1,
                      tuple(dict.fromkeys((torch.float32, x.dtype))))
    tensors = [x, dt, a, b_in, c_in, d]
    if state is not None:
        _build.check_cuda("state", state, 4, _F32)
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
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    final = torch.empty((bb, h, p, n), dtype=torch.float32, device=x.device)
    ds, clast = scratch(bb, s, h, p, n, x.device)
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
    return y, final
