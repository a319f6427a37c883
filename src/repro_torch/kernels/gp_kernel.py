"""CUDA kernels for the GP path: covariance assembly, its gradient in the
hyperparameters, and the batched predict (`csrc/gp_kernel.cu`), bound
through a plain C interface.

Each wrapper replaces one Pallas kernel of `repro/kernels/gp_kernel.py`:

  * `gp_kernel_matrix`   <- `gp_kernel_matrix` (`_gp_kernel`)
  * `gp_predict`         <- `gp_predict` (`_gp_predict_kernel`)
  * `gp_predict_experts` <- `gp_predict_experts` (`_gp_predict_experts_kernel`)

and `gp_kernel_matrix_grad` replaces what has no Pallas kernel: XLA's
autodiff of `repro.kernels.ref.gp_kernel_matrix` inside `repro.uq.gp._fit`.
`gp_kernel_matrix` is differentiable in the lengthscale and the variance,
and its backward is `gp_kernel_matrix_grad` (two kernels).

The library is compiled with `nvcc` for `sm_90a` at first use and loaded
with `ctypes` (`_build.Library`).
Wrappers take CUDA f32 contiguous tensors only and raise on anything else;
they launch on `torch.cuda.current_stream()`, allocate outputs with
`torch.empty`, and raise when a launch reports an error.

A predict call (`gp_predict`, `gp_predict_experts`) is three kernels and
nothing else on the device: K0 and the mean's partial sums per 32-row
block (`gp_predict_k0`), the triangular product L^-1 K0 with each row
block's sum of squares (`gp_predict_tri`), and the fixed-order reduction
that also applies the variance and its square (`gp_predict_reduce`).
Its f32 scratch (`predict_scratch`) is allocated with `torch.empty` per
call.  A gradient call (`gp_kernel_matrix_grad`) is two kernels: the
tiles' partial sums into a [D + 1, blocks] scratch (`grad_scratch`), and
their fixed-order reduction with the scaling.  `launches` counts one per
wrapper call, whatever the kernels per call.  What bounds each kernel on
the H100, and what its design does about it, is written beside the
kernel in the CUDA source.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "gp_kernel.cu"

KINDS = {"rbf": 0, "matern52": 1}
MAX_DIM = 16           # kMaxDim in the CUDA source
MAX_OUT = 4            # kMaxOut
TILE_QUERIES = 64      # kQ: queries per predict tile
ROW_BLOCK = 32         # kB: training rows per block of K0 and of L^-1
KM_COLS = 32           # kKmCols: covariance tile columns, one per lane
KM_WARPS = 8           # kKmWarps: a thread takes tile rows / KM_WARPS rows
KM_SMALL_ROWS = 32     # kKmSmallRows, kKmLargeRows: the two tiles' rows
KM_LARGE_ROWS = 64
# 32-row blocks in one wave on an H100 (132 SMs x 8 resident blocks of 256
# threads): above it the covariance kernels take the 64-row tile
KM_LARGE_ABOVE = 132 * 8
GRAD_REDUCE_THREADS = 256  # kGradRedThreads

launches = _build.Launches("gp_kernel_matrix", "gp_kernel_matrix_grad",
                           "gp_predict", "gp_predict_experts")
reset_launches = launches.reset


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gp_kernel_matrix_f32.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.gp_kernel_matrix_f32.restype = i
    lib.gp_kernel_matrix_grad_f32.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.gp_kernel_matrix_grad_f32.restype = i
    lib.gp_predict_f32.argtypes = [p] * 11 + [i] * 6 + [p]
    lib.gp_predict_f32.restype = i
    consts = ("gp_kernel_tile_queries", "gp_kernel_row_block",
              "gp_kernel_max_dim", "gp_kernel_max_out",
              "gp_kernel_km_small_rows", "gp_kernel_km_large_rows",
              "gp_kernel_km_warps", "gp_kernel_grad_reduce_threads")
    for fn in consts:
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i
    got = tuple(getattr(lib, fn)() for fn in consts)
    if got != (TILE_QUERIES, ROW_BLOCK, MAX_DIM, MAX_OUT, KM_SMALL_ROWS,
               KM_LARGE_ROWS, KM_WARPS, GRAD_REDUCE_THREADS):
        raise RuntimeError(f"kernel constants {got} disagree with the "
                           f"wrapper's")


_LIB = _build.Library(SOURCE, _declare)
load = _LIB.load
build_info = _LIB.info     # path, seconds, ptxas log of the build


def _check(name: str, t: torch.Tensor, ndim: int) -> None:
    _build.check_cuda(name, t, ndim, (torch.float32,))


def _kind(kind: str) -> int:
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    return KINDS[kind]


# --------------------------------------------------------------------------
def _kernel_matrix_operands(x1, x2, lengthscale, variance):
    """Check the covariance operands; returns (n, m, d)."""
    _check("x1", x1, 2)
    _check("x2", x2, 2)
    _check("lengthscale", lengthscale, 1)
    _check("variance", variance, 0)
    _build.same_device(x1, x2, lengthscale, variance)
    n, d = x1.shape
    m = x2.shape[0]
    if x2.shape[1] != d or lengthscale.shape[0] != d:
        raise ValueError(f"shape mismatch: x1 {tuple(x1.shape)}, x2 "
                         f"{tuple(x2.shape)}, lengthscale "
                         f"{tuple(lengthscale.shape)}")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"input dimension {d} outside 1..{MAX_DIM}")
    if -(-n // km_tile_rows(n, m)) > 65535:
        raise ValueError(f"x1 has {n} rows; the grid takes at most "
                         f"{65535 * km_tile_rows(n, m)}")
    return n, m, d


def km_tile_rows(n: int, m: int) -> int:
    """The tile rows of the covariance kernels for K [n, m]: 64 once the
    32-row grid is more than one wave of resident blocks on an H100, else
    32 (more, smaller blocks fill more SMs)."""
    blocks = -(-m // KM_COLS) * -(-n // KM_SMALL_ROWS)
    return KM_LARGE_ROWS if blocks > KM_LARGE_ABOVE else KM_SMALL_ROWS


def _kernel_matrix_launch(x1, x2, lengthscale, variance, kind):
    n, m, d = _kernel_matrix_operands(x1, x2, lengthscale, variance)
    out = torch.empty((n, m), dtype=torch.float32, device=x1.device)
    lib = load()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gp_kernel_matrix_f32(
            x1.data_ptr(), x2.data_ptr(), lengthscale.data_ptr(),
            variance.data_ptr(), out.data_ptr(), n, m, d, _kind(kind),
            km_tile_rows(n, m), stream)
    _build.raise_on(err, "gp_kernel_matrix")
    launches.count("gp_kernel_matrix")
    return out


def grad_scratch(n: int, m: int, d: int) -> Tuple[int, int]:
    """Shape of a gradient call's f32 scratch: the D + 1 partial sums of
    each [km_tile_rows(n, m), KM_COLS] tile of K, each sum's partials
    contiguous, tiles in row-major order."""
    return (d + 1, -(-m // KM_COLS) * -(-n // km_tile_rows(n, m)))


def grad_operands(grad: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad, x1, x2) as the gradient kernel takes them: grad row-major.
    A column-major grad (as autograd hands it over from the Cholesky) is
    taken transposed with x1 and x2 swapped, without a copy: K(x1, x2)^T
    = K(x2, x1), and the kernel's terms are symmetric in the two points
    (the same products, a commutative sum, (a - b)^2 = (b - a)^2), so
    only the summation order changes.  Any other layout is copied."""
    if not grad.is_contiguous() and grad.dim() == 2 and grad.T.is_contiguous():
        return grad.T, x2, x1
    return grad.contiguous(), x1, x2


def gp_kernel_matrix_grad(grad: torch.Tensor, x1: torch.Tensor,
                          x2: torch.Tensor, lengthscale: torch.Tensor,
                          variance: torch.Tensor, kind: str = "rbf"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `gp_kernel_matrix` in the lengthscale and the
    variance against K's upstream gradient `grad` [N, M] -> (g_ls [D],
    g_var []), on the card, in two kernels and a fixed summation order (no
    atomics: reruns give identical bits).  `ref.gp_kernel_matrix_grad` is
    its plain version.  A column-major `grad` costs nothing more
    (`grad_operands`); any other strided one (autograd may hand one over
    expanded) is copied first, one more kernel."""
    grad, x1, x2 = grad_operands(grad, x1, x2)
    n, m, d = _kernel_matrix_operands(x1, x2, lengthscale, variance)
    _check("grad", grad, 2)
    _build.same_device(grad, x1)
    if tuple(grad.shape) != (n, m):
        raise ValueError(f"grad {tuple(grad.shape)} is not K's shape "
                         f"{(n, m)}")
    dev = x1.device
    g_ls = torch.empty((d,), dtype=torch.float32, device=dev)
    g_var = torch.empty((), dtype=torch.float32, device=dev)
    part = torch.empty(grad_scratch(n, m, d), dtype=torch.float32,
                       device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gp_kernel_matrix_grad_f32(
            grad.data_ptr(), x1.data_ptr(), x2.data_ptr(),
            lengthscale.data_ptr(), variance.data_ptr(), part.data_ptr(),
            g_ls.data_ptr(), g_var.data_ptr(), n, m, d, _kind(kind),
            km_tile_rows(n, m), stream)
    _build.raise_on(err, "gp_kernel_matrix_grad")
    launches.count("gp_kernel_matrix_grad")
    return g_ls, g_var


class _KernelMatrix(torch.autograd.Function):
    """Forward: the covariance kernel.  Backward: `gp_kernel_matrix_grad`,
    the closed-form gradient in the lengthscale and the variance (what
    `fit` needs) in two kernels; the inputs get none."""

    @staticmethod
    def forward(ctx, x1, x2, lengthscale, variance, kind):
        ctx.save_for_backward(x1, x2, lengthscale, variance)
        ctx.kind = kind
        return _kernel_matrix_launch(x1, x2, lengthscale, variance, kind)

    @staticmethod
    def backward(ctx, grad):
        x1, x2, lengthscale, variance = ctx.saved_tensors
        g_ls, g_var = gp_kernel_matrix_grad(grad, x1, x2, lengthscale,
                                            variance, ctx.kind)
        need = ctx.needs_input_grad
        return (None, None, g_ls if need[2] else None,
                g_var if need[3] else None, None)


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
def predict_scratch(e: int, n: int, s: int,
                    m: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of a predict call's f32 scratch, with the training rows cut
    into NB blocks of 32 and the queries padded to SP, a multiple of 64:
    K0 [E, 32 NB, SP], the mean's partial sums per row block [E, NB, SP, M]
    and each row block's sum of squares of L^-1 K0 [E, NB, SP]."""
    nb = -(-n // ROW_BLOCK)
    sp = -(-s // TILE_QUERIES) * TILE_QUERIES
    return {"k0": (e, nb * ROW_BLOCK, sp), "mpart": (e, nb, sp, m),
            "qpart": (e, nb, sp)}


def _predict_launch(name, x_train, x_star, lengthscale, variance, alpha,
                    linv, kind) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared launch for [E, ...] stacked operands."""
    for nm, t, nd in (("x_train", x_train, 3), ("x_star", x_star, 3),
                      ("lengthscale", lengthscale, 1),
                      ("variance", variance, 0), ("alpha", alpha, 3),
                      ("linv", linv, 3)):
        _check(nm, t, nd)
    _build.same_device(x_train, x_star, lengthscale, variance, alpha, linv)
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
    mean = torch.empty((e, s, m), dtype=torch.float32, device=dev)
    qf = torch.empty((e, s), dtype=torch.float32, device=dev)
    scratch = [torch.empty(shape, dtype=torch.float32, device=dev)
               for shape in predict_scratch(e, n, s, m).values()]
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gp_predict_f32(
            x_train.data_ptr(), x_star.data_ptr(), lengthscale.data_ptr(),
            alpha.data_ptr(), linv.data_ptr(), variance.data_ptr(),
            mean.data_ptr(), qf.data_ptr(),
            *(t.data_ptr() for t in scratch), e, n, s, d, m, _kind(kind),
            stream)
    _build.raise_on(err, name)
    launches.count(name)
    return mean, qf


def gp_predict(x_train: torch.Tensor, x_star: torch.Tensor,
               lengthscale: torch.Tensor, variance: torch.Tensor,
               alpha: torch.Tensor, linv: torch.Tensor, kind: str = "rbf"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched GP posterior predict in one call (three kernels).

    x_train: [N, D]; x_star: [S, D]; alpha: [N, M]; linv: [N, N], the
    LOWER-TRIANGULAR inverse Cholesky factor of K + s2 I (the kernel skips
    its upper part) -> (normalised mean [S, M], ||L^-1 ks||^2 [S]).  The
    kernels work on the unscaled correlation; the last scales the mean by
    `variance` and the quadratic form by `variance`^2, as the Pallas
    wrapper does after its kernel.
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
    """Stacked local-GP ensemble predict: all E experts in one call (the
    expert is a grid dimension of each of the three kernels).

    x_train: [E, N, D]; x_star: [E, S, D]; alpha: [E, N, M];
    linv: [E, N, N] lower-triangular -> (mean [E, S, M], qf [E, S]).
    Zero-padded training rows are exact (alpha and linv zero there).
    """
    return _predict_launch("gp_predict_experts", x_train, x_star,
                           lengthscale, variance, alpha, linv, kind)
