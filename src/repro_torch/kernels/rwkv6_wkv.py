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
does.  `launches` adds one per call (its three kernels count once).
What bounds the kernel on the H100, and what its design does about it,
is written beside the kernel in the CUDA source.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_wkv.cu"
MAX_K = 128               # kMaxK in the CUDA source
CHUNK = 64                # kC in the CUDA source: steps per chunk
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = (torch.float32,)

launches = _build.Launches("rwkv6_wkv")
reset_launches = launches.reset


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_wkv_fwd.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.rwkv6_wkv_fwd.restype = i
    for fn in (lib.rwkv6_wkv_max_k, lib.rwkv6_wkv_chunk):
        fn.argtypes = []
        fn.restype = i
    if (lib.rwkv6_wkv_max_k(), lib.rwkv6_wkv_chunk()) != (MAX_K, CHUNK):
        raise RuntimeError("kernel's key-width limit or chunk length "
                           "disagrees with the wrapper's")


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


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor] = None, *, chunk: int = 64
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k: [B,S,H,K]; v: [B,S,H,V] in r's dtype; w: [B,S,H,K] f32;
    u: [H,K] in r's dtype; state: [B,H,K,V] f32 or None (zeros).  Returns
    (out [B,S,H,V] in r's dtype, final state [B,H,K,V] f32).

    `chunk` is the reference's chunk length; the kernel cuts the sequence
    into chunks of its own (64 steps), and the result does not depend on
    the length beyond rounding, so it only has to be positive."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    _build.refuse_grad(
        "rwkv6_wkv", r, k, v, w, u, state,
        reason="it has no backward kernel yet (ROADMAP.md Queue 1 item "
               "22b); training through it runs on the CPU only")
    _build.check_cuda("r", r, 4, tuple(DTYPES))
    for name, t in (("k", k), ("v", v)):
        _build.check_cuda(name, t, 4, (r.dtype,))
    _build.check_cuda("w", w, 4, _F32)
    _build.check_cuda("u", u, 2, (r.dtype,))
    tensors = [r, k, v, w, u]
    if state is not None:
        _build.check_cuda("state", state, 4, _F32)
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
    out = torch.empty(v.shape, dtype=r.dtype, device=r.device)
    final = torch.empty((b, h, kd, vd), dtype=torch.float32, device=r.device)
    ds, clast = scratch(b, s, h, kd, vd, r.device)
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
    return out, final
