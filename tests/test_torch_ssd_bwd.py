"""The plain version of the SSD backward (`repro_torch.kernels.ref.
mamba2_ssd_bwd`) against the reference, on the CPU.

The reference has no backward of its own for the SSD: XLA differentiates
whatever the forward is.  Its sequential scan (`repro.kernels.ref.
mamba2_ssd`) differentiates cleanly, so `jax.vjp` of the scan, with the
final state's gradient included, is the oracle here; the chunked form
(`mamba2_ssd_chunked`) is NaN at zamba2's 256-step chunk, forward and
backward (pinned below).  The same numpy inputs and output gradients go
through both.  The plain backward is also held to torch autograd of the
port's plain forward (`ref.mamba2_ssd`).

Tolerance: 1e-4 of max|g| per tensor, in f32.  The plain backward sums
over 64-step chunks in f32, the scan step by step; the largest gap seen
is 1.7e-5, for `a` under a strong decay (a sum over (B, S, P, N), scaled
by |a| ~ 8 there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

NAMES = ("x", "dt", "a", "b", "c", "d", "state")
REL = 1e-4


def _inputs(b, s, h, p, n, *, a_scale=1.0, seed=3):
    """x, B, C, D, dy, dstate_out ~ N(0, 1); dt = softplus(N(0, 1));
    a = -a_scale exp(0.3 N(0, 1)); the state 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-a_scale * np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    bi = rng.standard_normal((b, s, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    st = (0.1 * rng.standard_normal((b, h, p, n))).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dso = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a, bi, ci, d, st), dy, dso


def _port(args, dy, dso, with_state, with_dso):
    t = [torch.from_numpy(v) for v in args]
    return tref.mamba2_ssd_bwd(
        *t[:6], t[6] if with_state else None, torch.from_numpy(dy),
        torch.from_numpy(dso) if with_dso else None)


def _assert_close(got, want, names=NAMES):
    for name, g, w in zip(names, got, want):
        if g is None:
            continue
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.isfinite(g).all(), name
        err = float(np.abs(g - w).max())
        assert err <= REL * float(np.abs(w).max()), (name, err,
                                                     float(np.abs(w).max()))


# (b, s, h, p, n, with_state, a_scale)
CASES = [
    (2, 100, 3, 8, 16, True, 1.0),      # B > 1, H > 1, ragged S
    (2, 100, 3, 8, 16, False, 1.0),     # without a state
    (1, 64, 2, 16, 16, True, 1.0),      # exactly one chunk
    (1, 1, 2, 8, 16, True, 1.0),        # one step
    (1, 70, 2, 8, 128, True, 1.0),      # the widest state the kernel takes
    (1, 257, 2, 16, 64, True, 8.0),     # strong decay, zamba2's N, ragged
]


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp_of_the_scan(case):
    b, s, h, p, n, with_state, a_scale = case
    args, dy, dso = _inputs(b, s, h, p, n, a_scale=a_scale)
    jargs = list(args)
    if not with_state:
        jargs[6] = np.zeros_like(args[6])   # the reference's own default
    _, vjp = jax.vjp(jref.mamba2_ssd, *jargs)
    want = vjp((jnp.asarray(dy), jnp.asarray(dso)))
    got = _port(args, dy, dso, with_state, True)
    assert (got[6] is None) == (not with_state)
    _assert_close(got, want)


def test_plain_backward_without_a_state_gradient():
    """dstate_out = None is a zero cotangent for the final state."""
    args, dy, dso = _inputs(2, 130, 2, 8, 16, seed=4)
    _, vjp = jax.vjp(jref.mamba2_ssd, *args)
    want = vjp((jnp.asarray(dy), jnp.zeros_like(jnp.asarray(dso))))
    _assert_close(_port(args, dy, dso, True, False), want)


@pytest.mark.parametrize("chunk", [32, 64, 256])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(chunk, with_state):
    """The same gradient as torch autograd through `ref.mamba2_ssd`, at
    the forward's chunk lengths (the backward's own is 64)."""
    args, dy, dso = _inputs(2, 150, 3, 8, 16, seed=6)
    leaves = [torch.from_numpy(v).requires_grad_() for v in args]
    state = leaves[6] if with_state else None
    y, fin = tref.mamba2_ssd(*leaves[:6], state, chunk=chunk)
    want = torch.autograd.grad(
        (y, fin), leaves[:6] + ([state] if with_state else []),
        (torch.from_numpy(dy), torch.from_numpy(dso)))
    got = _port(args, dy, dso, with_state, True)
    _assert_close(got, [w.numpy() for w in want])


def test_plain_backward_returns_each_operand_type():
    """bf16 x, B, C and D (the model's activations and its D-skip): each
    gradient in its operand's type, dt, a and the state in f32, equal to
    the f32 gradient on the same rounded inputs up to one rounding of the
    result (2^-8 relative) and the bf16 dy's."""
    args, dy, dso = _inputs(1, 90, 2, 8, 16, seed=7)
    t = [torch.from_numpy(v) for v in args]
    bf = torch.bfloat16
    for i in (0, 3, 4, 5):
        t[i] = t[i].to(bf)
    dy16 = torch.from_numpy(dy).to(bf)
    got = tref.mamba2_ssd_bwd(*t, dy16, torch.from_numpy(dso))
    want = tref.mamba2_ssd_bwd(*(v.float() for v in t), dy16.float(),
                               torch.from_numpy(dso))
    for name, g, w, op in zip(NAMES, got, want, t):
        assert g.dtype == op.dtype, name
        scale = float(w.abs().max())
        assert float((g.float() - w).abs().max()) <= 2 ** -8 * scale, name


def test_reference_chunked_backward_is_nan_where_the_port_is_finite():
    """XLA's gradient of the reference's `mamba2_ssd_chunked` at zamba2's
    256-step chunk (what the reference trains through) is NaN: its forward
    takes exp(cum_t - cum_j) above the diagonal too, where it overflows,
    and inf * 0 = NaN, forward and backward.  The port's plain backward
    takes only exponents <= 0: finite, and equal to the scan's gradient."""
    args, dy, dso = _inputs(1, 300, 2, 8, 16, seed=11)
    args = list(args)
    args[2] = -np.ones(2, np.float32)       # zamba2's a_log init is 0
    _, vjp = jax.vjp(lambda *v: jref.mamba2_ssd_chunked(*v, chunk=256),
                     *args)
    chunked = vjp((jnp.asarray(dy), jnp.asarray(dso)))
    assert any(np.isnan(np.asarray(g)).any() for g in chunked)
    _, vjp = jax.vjp(jref.mamba2_ssd, *args)
    want = vjp((jnp.asarray(dy), jnp.asarray(dso)))
    _assert_close(_port(args, dy, dso, True, True), want)
