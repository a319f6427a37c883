"""CUDA kernels for the GP path: covariance assembly and the fused
batched predict (`csrc/gp_kernel.cu`), bound through a plain C interface.

Each wrapper replaces one Pallas kernel of `repro/kernels/gp_kernel.py`:

  * `gp_kernel_matrix`   <- `gp_kernel_matrix` (`_gp_kernel`)
  * `gp_predict`         <- `gp_predict` (`_gp_predict_kernel`)
  * `gp_predict_experts` <- `gp_predict_experts` (`_gp_predict_experts_kernel`)

The library is compiled with `nvcc` for `sm_90a` at first use into
`build/repro_torch/` at the root of the checkout, named by a hash of the
source so that an edited kernel is rebuilt, and loaded with `ctypes`.
Wrappers take CUDA f32 contiguous tensors only and raise on anything else;
they launch on `torch.cuda.current_stream()`, allocate outputs (and the
predict's k0 scratch) with `torch.empty`, and raise when the launch
reports an error.  `launches` counts the kernel launches of each wrapper.
What bounds each kernel on the H100, and what its design does about it,
is written beside the kernel in the CUDA source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gp_kernel.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KINDS = {"rbf": 0, "matern52": 1}
MAX_DIM = 16           # kMaxDim in the CUDA source
MAX_OUT = 4            # kMaxOut
TILE_QUERIES = 32      # kPTile: queries per predict block

launches: Dict[str, int] = {"gp_kernel_matrix": 0, "gp_predict": 0,
                            "gp_predict_experts": 0}
_count_lock = threading.Lock()

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
build_info: Dict[str, object] = {}     # path, seconds, ptxas log of the build


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc) to "
                           "build the GP kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile the kernels' shared library unless a build of this exact
    source exists; returns its path."""
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libgp_kernel_{digest}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders never see half a file
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr)
    return out


def load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.gp_kernel_matrix_f32.argtypes = [p, p, p, p, p, i, i, i, i, p]
            lib.gp_kernel_matrix_f32.restype = i
            lib.gp_predict_f32.argtypes = [p] * 8 + [i] * 6 + [p]
            lib.gp_predict_f32.restype = i
            for fn in ("gp_kernel_tile_queries", "gp_kernel_max_dim",
                       "gp_kernel_max_out"):
                getattr(lib, fn).argtypes = []
                getattr(lib, fn).restype = i
            got = (lib.gp_kernel_tile_queries(), lib.gp_kernel_max_dim(),
                   lib.gp_kernel_max_out())
            if got != (TILE_QUERIES, MAX_DIM, MAX_OUT):
                raise RuntimeError(f"kernel constants {got} disagree with "
                                   f"the wrapper's")
            _lib = lib
        return _lib


def _check(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _same_device(*ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{sorted({str(t.device) for t in ts})}")


def _kind(kind: str) -> int:
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    return KINDS[kind]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# --------------------------------------------------------------------------
def _kernel_matrix_launch(x1, x2, lengthscale, variance, kind):
    _check("x1", x1, 2)
    _check("x2", x2, 2)
    _check("lengthscale", lengthscale, 1)
    _check("variance", variance, 0)
    _same_device(x1, x2, lengthscale, variance)
    n, d = x1.shape
    m = x2.shape[0]
    if x2.shape[1] != d or lengthscale.shape[0] != d:
        raise ValueError(f"shape mismatch: x1 {tuple(x1.shape)}, x2 "
                         f"{tuple(x2.shape)}, lengthscale "
                         f"{tuple(lengthscale.shape)}")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"input dimension {d} outside 1..{MAX_DIM}")
    if (n + 31) // 32 > 65535:
        raise ValueError(f"x1 has {n} rows; the grid takes at most "
                         f"{65535 * 32}")
    out = torch.empty((n, m), dtype=torch.float32, device=x1.device)
    lib = load()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gp_kernel_matrix_f32(
            x1.data_ptr(), x2.data_ptr(), lengthscale.data_ptr(),
            variance.data_ptr(), out.data_ptr(), n, m, d, _kind(kind),
            stream)
    _raise_on(err, "gp_kernel_matrix")
    _count("gp_kernel_matrix")
    return out


class _KernelMatrix(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the plain version's autograd,
    recomputed with torch ops (the JAX reference has no backward kernel
    either: XLA differentiates `ref.gp_kernel_matrix`), which gives the
    gradients for the lengthscale and the variance that fit needs."""

    @staticmethod
    def forward(ctx, x1, x2, lengthscale, variance, kind):
        ctx.save_for_backward(x1, x2, lengthscale, variance)
        ctx.kind = kind
        return _kernel_matrix_launch(x1, x2, lengthscale, variance, kind)

    @staticmethod
    def backward(ctx, grad):
        x1, x2, lengthscale, variance = ctx.saved_tensors
        with torch.enable_grad():
            ls = lengthscale.detach().requires_grad_()
            var = variance.detach().requires_grad_()
            k = ref.gp_kernel_matrix(x1, x2, ls, var, ctx.kind)
            g_ls, g_var = torch.autograd.grad(k, (ls, var), grad)
        return None, None, g_ls, g_var, None


def gp_kernel_matrix(x1: torch.Tensor, x2: torch.Tensor,
                     lengthscale: torch.Tensor, variance: torch.Tensor,
                     kind: str = "rbf") -> torch.Tensor:
    """x1: [N,D]; x2: [M,D]; ARD lengthscale: [D]; variance: [] -> K [N,M]
    f32, on the card.  Differentiable in the lengthscale and variance."""
    if x1.requires_grad or x2.requires_grad:
        raise ValueError("gp_kernel_matrix differentiates the "
                         "hyperparameters only, not the inputs")
    if lengthscale.requires_grad or variance.requires_grad:
        return _KernelMatrix.apply(x1, x2, lengthscale, variance, kind)
    return _kernel_matrix_launch(x1, x2, lengthscale, variance, kind)


# --------------------------------------------------------------------------
def _predict_launch(name, x_train, x_star, lengthscale, variance, alpha,
                    linv, kind) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared launch for [E, ...] stacked operands."""
    for nm, t, nd in (("x_train", x_train, 3), ("x_star", x_star, 3),
                      ("lengthscale", lengthscale, 1),
                      ("variance", variance, 0), ("alpha", alpha, 3),
                      ("linv", linv, 3)):
        _check(nm, t, nd)
    _same_device(x_train, x_star, lengthscale, variance, alpha, linv)
    e, n, d = x_train.shape
    s = x_star.shape[1]
    m = alpha.shape[2]
    if (x_star.shape[0] != e or x_star.shape[2] != d
            or tuple(alpha.shape[:2]) != (e, n)
            or tuple(linv.shape) != (e, n, n)
            or lengthscale.shape[0] != d):
        raise ValueError(
            f"shape mismatch: x_train {tuple(x_train.shape)}, x_star "
            f"{tuple(x_star.shape)}, alpha {tuple(alpha.shape)}, linv "
            f"{tuple(linv.shape)}, lengthscale {tuple(lengthscale.shape)}")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"input dimension {d} outside 1..{MAX_DIM}")
    if not 1 <= m <= MAX_OUT:
        raise ValueError(f"{m} output columns outside 1..{MAX_OUT}")
    if n < 1 or not 1 <= e <= 65535:
        raise ValueError(f"need 1..65535 experts of at least one training "
                         f"row, got e={e}, n={n}")
    dev = x_train.device
    mean0 = torch.empty((e, s, m), dtype=torch.float32, device=dev)
    qf0 = torch.empty((e, s), dtype=torch.float32, device=dev)
    tiles = -(-s // TILE_QUERIES)
    k0 = torch.empty((e, tiles, n, TILE_QUERIES), dtype=torch.float32,
                     device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gp_predict_f32(
            x_train.data_ptr(), x_star.data_ptr(), lengthscale.data_ptr(),
            alpha.data_ptr(), linv.data_ptr(), mean0.data_ptr(),
            qf0.data_ptr(), k0.data_ptr(), e, n, s, d, m, _kind(kind),
            stream)
    _raise_on(err, name)
    _count(name)
    return variance * mean0, (variance * variance) * qf0


def gp_predict(x_train: torch.Tensor, x_star: torch.Tensor,
               lengthscale: torch.Tensor, variance: torch.Tensor,
               alpha: torch.Tensor, linv: torch.Tensor, kind: str = "rbf"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched GP posterior predict in one launch.

    x_train: [N, D]; x_star: [S, D]; alpha: [N, M]; linv: [N, N], the
    LOWER-TRIANGULAR inverse Cholesky factor of K + s2 I (the kernel skips
    its upper part) -> (normalised mean [S, M], ||L^-1 ks||^2 [S]).  The
    kernel works on the unscaled correlation; mean is scaled by `variance`
    and the quadratic form by `variance`^2 here, as in the Pallas wrapper.
    """
    mean, qf = _predict_launch("gp_predict", x_train[None], x_star[None],
                               lengthscale, variance, alpha[None],
                               linv[None], kind)
    return mean[0], qf[0]


def gp_predict_experts(x_train: torch.Tensor, x_star: torch.Tensor,
                       lengthscale: torch.Tensor, variance: torch.Tensor,
                       alpha: torch.Tensor, linv: torch.Tensor,
                       kind: str = "rbf"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked local-GP ensemble predict: all E experts in ONE launch
    (the expert index is the grid's y dimension).

    x_train: [E, N, D]; x_star: [E, S, D]; alpha: [E, N, M];
    linv: [E, N, N] lower-triangular -> (mean [E, S, M], qf [E, S]).
    Zero-padded training rows are exact (alpha and linv zero there).
    """
    return _predict_launch("gp_predict_experts", x_train, x_star,
                           lengthscale, variance, alpha, linv, kind)
