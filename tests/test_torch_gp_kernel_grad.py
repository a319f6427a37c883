"""The gradient of the covariance matrix in the hyperparameters, on the CPU.

On the card, `gp_kernel_matrix`'s backward is the CUDA kernel
`gp_kernel_matrix_grad` (`csrc/gp_kernel.cu`): the closed form

    g_var  = sum G k(d2)
    g_ls_c = var / ls_c * sum G h(d2) (x1s_c - x2s_c)^2,  h = -2 dk/dd2,

in two kernels with a fixed summation order: each thread sums its rows of
a [rows, KM_COLS] tile in row order (rows = 32 or 64 by `km_tile_rows`),
each block its threads in a fixed tree (lanes by halves, then the warps
in order) into a [D + 1, blocks] scratch in tile order, and the second
kernel sums the blocks (thread t takes blocks t, t + 256, ..., then the
same tree) and scales.  Its plain
version is `repro_torch.kernels.ref.gp_kernel_matrix_grad`.

Held here, on identical numpy inputs:
  * the plain closed form against the autograd of the port's
    `ref.gp_kernel_matrix` and against `jax.grad` of
    `repro.kernels.ref.gp_kernel_matrix`;
  * `_grad_emulation`, that arithmetic in f32 in the kernel's order,
    against the plain closed form, the JAX gradient and float64.

Tolerances are relative to the sum of the absolute terms of each
component, `scale` = the plain closed form on |G| (every term has G's sign,
so that is exactly sum |term|): the f32 condition of a sum whose terms have
both signs.  Against an autodiff (torch or JAX): 1e-4 * scale, as the
card's gradient test holds the kernel to the autograd (tests/
test_torch_cuda.py); the autodiffs differentiate the expanded d2, whose
terms are larger than the closed form's and cancel.  Closed form against
closed form (the emulation against the plain version, f32 against
float64): 1e-5 * scale, a few dozen f32 roundings in sequence at most.
Matern-5/2 at x1 = x2 is held against float64, not against an autodiff:
there the autodiffs differentiate sqrt(d2 + 1e-12) at d2 near 0, where
dk/dd2 is the difference of two terms of order 1/(2r) (5e5 at d2 = 0) and
can be noisy in f32; the closed form has no such term.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import gp_kernel, ops
from repro_torch.kernels import ref as tref
from torch_port_util import on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

TOL_AUTODIFF = 1e-4
TOL_CLOSED = 1e-5
KINDS = ("rbf", "matern52")


def _inputs(n, m, d, same=False, seed=0):
    """x1 [n, d], x2 [m, d] (x1 itself where `same`), ARD lengthscales,
    a variance and an upstream gradient of both signs, as numpy f32."""
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((n, d)).astype(np.float32)
    x2 = x1 if same else rng.standard_normal((m, d)).astype(np.float32)
    ls = np.exp(0.3 * rng.standard_normal(d) + 0.2 * np.sqrt(d)).astype(
        np.float32)
    var = np.float32(1.7)
    g = rng.standard_normal((n, x2.shape[0])).astype(np.float32)
    return x1, x2, ls, var, g


def _t(*arrays, dtype=torch.float32):
    return [torch.tensor(np.asarray(a), dtype=dtype) for a in arrays]


def _plain(x1, x2, ls, var, g, kind, dtype=torch.float32):
    x1, x2, ls, var, g = _t(x1, x2, ls, var, g, dtype=dtype)
    return [t.numpy() for t in tref.gp_kernel_matrix_grad(g, x1, x2, ls,
                                                          var, kind)]


def _scale(x1, x2, ls, var, g, kind):
    """sum |term| per component: the plain closed form on |G| in float64."""
    return _plain(x1, x2, ls, var, np.abs(g), kind, torch.float64)


def _torch_autograd(x1, x2, ls, var, g, kind):
    x1, x2, ls, var, g = _t(x1, x2, ls, var, g)
    ls.requires_grad_()
    var.requires_grad_()
    k = tref.gp_kernel_matrix(x1, x2, ls, var, kind)
    return [t.numpy() for t in torch.autograd.grad(k, (ls, var), g)]


def _jax_grad(x1, x2, ls, var, g, kind):
    def f(ls_, var_):
        return jnp.sum(jref.gp_kernel_matrix(jnp.asarray(x1), jnp.asarray(x2),
                                             ls_, var_, kind)
                       * jnp.asarray(g))
    return [np.asarray(t) for t in jax.grad(f, argnums=(0, 1))(
        jnp.asarray(ls), jnp.asarray(var))]


def _assert_within(got, want, scale, tol):
    for a, b, s in zip(got, want, scale):
        a, b, s = (np.asarray(v, np.float64) for v in (a, b, s))
        assert a.shape == b.shape
        err = np.abs(a - b)
        assert (err <= tol * s).all(), (err / s).max()


# --------------------------------------------------------------------------
def _lane_tree(v):
    """Each warp's lanes by halves (16, 8, 4, 2, 1) over the second to
    last axis (32 lanes): lane l takes l + off, as __shfl_down_sync."""
    off = v.shape[-2] // 2
    while off:
        v = v[..., :off, :] + v[..., off:2 * off, :]
        off //= 2
    return v[..., 0, :]


def _warps_in_order(v):
    """The warps' sums over axis 0 added in order, from 0."""
    s = np.zeros(v.shape[1:], np.float32)
    for w in range(v.shape[0]):
        s = s + v[w]
    return s


def _grad_emulation(x1, x2, ls, var, g, kind, tm):
    """The two gradient kernels' arithmetic, in f32 and in their order,
    for tiles of `tm` rows."""
    n, d = x1.shape
    m = x2.shape[0]
    warps, cols = gp_kernel.KM_WARPS, gp_kernel.KM_COLS
    rpt = tm // warps
    f32 = np.float32
    x1s, x2s = x1 / ls, x2 / ls
    n1 = np.zeros(n, f32)
    n2 = np.zeros(m, f32)
    cross = np.zeros((n, m), f32)
    for c in range(d):
        n1 = n1 + x1s[:, c] * x1s[:, c]
        n2 = n2 + x2s[:, c] * x2s[:, c]
        cross = cross + x1s[:, None, c] * x2s[None, :, c]
    raw = (n1[:, None] + n2[None, :]) - f32(2.0) * cross
    d2 = np.maximum(raw, f32(0.0))
    if kind == "rbf":
        k = np.exp(f32(-0.5) * d2)
        h = k
    else:
        s5 = f32(np.sqrt(5.0))
        r = np.sqrt(d2 + f32(1e-12))
        e = np.exp(-s5 * r)
        k = (f32(1.0) + s5 * r + f32(5.0 / 3.0) * d2) * e
        h = f32(5.0 / 3.0) * (f32(1.0) + s5 * r) * e
    h = np.where(raw >= 0, h, f32(0.0))
    w = g * h
    diff = x1s[:, None, :] - x2s[None, :, :]
    terms = np.concatenate([w[..., None] * diff * diff, (g * k)[..., None]],
                           -1)                                   # [n, m, d+1]
    # tiles: rows (row tiles, rows per thread, warps), columns (tiles, lanes)
    nby, nbx = -(-n // tm), -(-m // cols)
    tp = np.zeros((nby * tm, nbx * cols, d + 1), f32)
    tp[:n, :m] = terms
    tp = tp.reshape(nby, rpt, warps, nbx, cols, d + 1)
    acc = np.zeros((nby, warps, nbx, cols, d + 1), f32)
    for i in range(rpt):                     # each thread's rows in order
        acc = acc + tp[:, i]
    per_warp = _lane_tree(acc)               # [nby, warps, nbx, d+1]
    part = _warps_in_order(np.moveaxis(per_warp, 1, 0))     # [nby, nbx, d+1]
    part = part.reshape(nby * nbx, d + 1)    # blocks in tile order
    if tm == gp_kernel.km_tile_rows(n, m):
        assert part.T.shape == gp_kernel.grad_scratch(n, m, d)
    # the reduction: thread t takes blocks t, t + T, ... in order
    nt = gp_kernel.GRAD_REDUCE_THREADS
    rounds = -(-part.shape[0] // nt)
    padded = np.zeros((rounds * nt, d + 1), f32)
    padded[:part.shape[0]] = part
    thread = np.zeros((nt, d + 1), f32)
    for j in range(rounds):
        thread = thread + padded[j * nt:(j + 1) * nt]
    s = _warps_in_order(_lane_tree(thread.reshape(nt // 32, 32, d + 1)))
    return [(var * s[:d]) / ls, s[d]]


# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", [1, 2, 7, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_grad_matches_torch_autograd(kind, d):
    args = _inputs(37, 29, d, seed=d)
    _assert_within(_plain(*args, kind), _torch_autograd(*args, kind),
                   _scale(*args, kind), TOL_AUTODIFF)


@pytest.mark.parametrize("d", [1, 2, 7, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_grad_matches_jax_grad(kind, d):
    args = _inputs(37, 29, d, seed=10 + d)
    _assert_within(_plain(*args, kind), _jax_grad(*args, kind),
                   _scale(*args, kind), TOL_AUTODIFF)


@pytest.mark.parametrize("d", [2, 7])
def test_plain_grad_rbf_on_the_diagonal(d):
    """K(X, X): the diagonal's d2 is rounding noise around 0, clamped."""
    args = _inputs(48, 48, d, same=True, seed=20 + d)
    scale = _scale(*args, "rbf")
    plain = _plain(*args, "rbf")
    _assert_within(plain, _torch_autograd(*args, "rbf"), scale, TOL_AUTODIFF)
    _assert_within(plain, _jax_grad(*args, "rbf"), scale, TOL_AUTODIFF)


@pytest.mark.parametrize("d", [2, 7])
def test_plain_grad_matern_on_the_diagonal_matches_float64(d):
    args = _inputs(48, 48, d, same=True, seed=30 + d)
    _assert_within(_plain(*args, "matern52"),
                   _plain(*args, "matern52", torch.float64),
                   _scale(*args, "matern52"), TOL_CLOSED)


# (n, m, d, x2 is x1): one tile and a ragged one, several tiles of rows,
# K(X, X), one element, and more blocks than the reduction has threads
EMULATION_SHAPES = [(40, 30, 7, False), (70, 33, 3, False),
                    (65, 65, 16, True), (1, 1, 1, False),
                    (600, 520, 2, False), (130, 130, 7, True)]


@pytest.mark.parametrize("n,m,d,same", EMULATION_SHAPES)
@pytest.mark.parametrize("rows", [gp_kernel.KM_SMALL_ROWS,
                                  gp_kernel.KM_LARGE_ROWS])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_order_emulation_matches_plain_and_jax(kind, rows, n, m, d,
                                                      same):
    args = _inputs(n, m, d, same=same, seed=n + d)
    got = _grad_emulation(*args, kind, rows)
    scale = _scale(*args, kind)
    _assert_within(got, _plain(*args, kind, torch.float64), scale,
                   TOL_CLOSED)
    _assert_within(got, _plain(*args, kind), scale, TOL_CLOSED)
    if not (same and kind == "matern52"):
        _assert_within(got, _jax_grad(*args, kind), scale, TOL_AUTODIFF)


# (n, m, tile rows): one wave of 32-row blocks (1,056) or fewer takes the
# 32-row tile, more the 64-row one
@pytest.mark.parametrize("n,m,rows", [(1, 1, 32), (33, 65, 32), (512, 512, 32),
                                      (1024, 1024, 32), (1056, 1024, 32),
                                      (1057, 1024, 64), (2048, 2048, 64),
                                      (100_000, 31, 64)])
def test_tile_rows_and_grad_scratch_shape(n, m, rows):
    assert gp_kernel.km_tile_rows(n, m) == rows
    tiles = -(-m // gp_kernel.KM_COLS) * -(-n // rows)
    for d in (1, 7, 16):
        assert gp_kernel.grad_scratch(n, m, d) == (d + 1, tiles)


@pytest.mark.parametrize("kind", KINDS)
def test_column_major_grad_is_taken_transposed(kind):
    """The layout autograd hands over from the Cholesky (column-major) is
    taken as K(x2, x1)'s row-major gradient with the points swapped, with
    no copy, and gives the same gradient."""
    x1, x2, ls, var, g = _t(*_inputs(33, 20, 7, seed=6))
    col = g.T.contiguous().T                     # column-major, same values
    got_g, got_x1, got_x2 = gp_kernel.grad_operands(col, x1, x2)
    assert got_g.is_contiguous() and got_g.data_ptr() == col.data_ptr()
    assert got_x1 is x2 and got_x2 is x1 and tuple(got_g.shape) == (20, 33)
    swapped = tref.gp_kernel_matrix_grad(got_g, got_x1, got_x2, ls, var, kind)
    args = [a.numpy() for a in (x1, x2, ls, var, g)]
    _assert_within(swapped, _plain(*args, kind), _scale(*args, kind),
                   TOL_CLOSED)
    _assert_within(_grad_emulation(got_x1.numpy(), got_x2.numpy(),
                                   ls.numpy(), var.numpy(), got_g.numpy(),
                                   kind, gp_kernel.km_tile_rows(20, 33)),
                   _plain(*args, kind), _scale(*args, kind), TOL_CLOSED)
    row = gp_kernel.grad_operands(g, x1, x2)
    assert row[0] is g and row[1] is x1 and row[2] is x2
    strided = g[:, ::2]
    copied = gp_kernel.grad_operands(strided, x1, x2[::2])[0]
    assert copied.is_contiguous() and torch.equal(copied, strided)


def test_cpu_gradient_stays_the_plain_autograd():
    """On CPU tensors the dispatcher differentiates the plain version with
    autograd; the kernel's wrapper refuses them (no fallback)."""
    x1, x2, ls, var, g = _t(*_inputs(20, 12, 3, seed=5))
    ls.requires_grad_()
    var.requires_grad_()
    got = torch.autograd.grad(ops.gp_kernel_matrix(x1, x2, ls, var), (ls, var),
                              g)
    want = torch.autograd.grad(tref.gp_kernel_matrix(x1, x2, ls, var),
                               (ls, var), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        gp_kernel.gp_kernel_matrix_grad(g, x1, x2, ls.detach(), var.detach())
