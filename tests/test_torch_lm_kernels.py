"""The port's LM kernels' plain versions against the JAX reference, on the
CPU.

`repro_torch.kernels.ref.attention` and `mamba2_ssd` (what the dispatcher
runs for CPU tensors, and what the CUDA kernels are held against on the
card by tests/test_torch_cuda.py) against the reference's oracles, on the
same numpy inputs.  The attention oracle is `repro.kernels.ref.attention`,
not the Pallas kernel in interpret mode, which fails its own bf16 tests
on this JAX (ROADMAP.md Queue 3).  The SSD oracle is the sequential
`repro.kernels.ref.mamba2_ssd`: the reference's chunked form gives NaN at
long chunks, which a test here pins.

Tolerances: attention f32 2e-5 (same f32 formula, summation order of a
Dh-term dot product and a softmax over at most 257 keys); attention bf16
2e-2 (both round an f32 result to bf16, whose step at |x| < 4 is at most
2^-6); SSD 2e-3 (the reference's own, tests/test_kernels.py: chunked and
sequential sums differ in order over up to 100 steps).

The CUDA kernel's bf16 route rounds one value more than the reference:
each probability, to bf16, before the P V product on the tensor cores.  A
plain emulation of its arithmetic is held to the reference here at the
same 2e-2, so that the tolerance budget is known to cover that rounding
before a card sees it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import mamba2_ssd as ssd_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from torch_port_util import np32, on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

# (b, sq, skv, h, hkv, dh): tests/test_kernels.py's ATTN_SHAPES
ATTN_SHAPES = [
    (2, 128, 128, 4, 2, 64),
    (1, 100, 100, 4, 4, 32),
    (2, 64, 256, 8, 2, 64),
    (1, 1, 128, 4, 2, 64),
    (1, 257, 257, 2, 1, 128),
]
# (b, s, h, p, n): tests/test_kernels.py's SSD_SHAPES
SSD_SHAPES = [(2, 100, 3, 8, 16), (1, 64, 2, 16, 32), (1, 31, 1, 8, 8)]

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _attn_inputs(b, sq, skv, h, hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, dh)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_matches_reference(shape, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _attn_inputs(*shape)
    want = jref.attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                          causal=causal)
    got = tref.attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                         causal=causal)
    assert got.dtype == tdt
    np.testing.assert_allclose(np32(got.float()),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_attention_value_width_differs_from_key_width():
    """Dv != Dh (the MLA case) against the oracle, causal, GQA."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 37, 4, 24)).astype(np.float32)
    k = rng.standard_normal((1, 50, 2, 24)).astype(np.float32)
    v = rng.standard_normal((1, 50, 2, 40)).astype(np.float32)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tref.attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (1, 37, 4, 40)
    np.testing.assert_allclose(np32(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _tensor_core_attention(q, k, v, causal=True):
    """The arithmetic of the CUDA kernel's bf16 route, in plain PyTorch:
    products of bf16 values summed in f32 (exact products, so only the
    order of summation differs from the reference), the scale applied to
    the f32 scores, probabilities summed in f32 for the row sum but
    rounded to bf16 for P V (f32 sums), the output rounded once."""
    h, hkv = q.shape[2], k.shape[2]
    k = k.repeat_interleave(h // hkv, dim=2)
    v = v.repeat_interleave(h // hkv, dim=2)
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / math.sqrt(q.shape[-1])
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool).tril(diagonal=sk - sq)
        s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), v.float())
    return (o / p.sum(-1).transpose(1, 2)[..., None]).bfloat16()


# (b, sq, skv, h, hkv, dh, dv): zamba2's heads of 80, starcoder2's GQA
# group of 12 with heads of 128, MLA's Dh 192 / Dv 128
@pytest.mark.parametrize("shape", [(1, 200, 200, 32, 32, 80, 80),
                                   (1, 200, 200, 24, 2, 128, 128),
                                   (1, 70, 130, 4, 4, 192, 128)])
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_probabilities_stay_within_tolerance(shape, q_scale, causal):
    """bf16 inputs (q scaled by 8 for a peaked softmax): the emulation of
    the kernel's arithmetic is within 2e-2 of the reference's attention
    and of the port's plain version, which the card holds the kernel to."""
    b, sq, skv, h, hkv, dh, dv = shape
    rng = np.random.default_rng(7)
    q = (q_scale * rng.standard_normal((b, sq, h, dh))).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dv)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = _tensor_core_attention(tq, tk, tv, causal=causal)
    want = jref.attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(np32(got.float()),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(
        np32(got.float()),
        np32(tref.attention(tq, tk, tv, causal=causal).float()),
        atol=2e-2, rtol=2e-2)


def _ssd_inputs(b, s, h, p, n, seed=5, with_state=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bi = rng.standard_normal((b, s, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    st = ((rng.standard_normal((b, h, p, n)) * 0.1).astype(np.float32)
          if with_state else None)
    return x, dt, a, bi, ci, d, st


def _both(fn_t, fn_j, args, **kw):
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    return fn_t(*targs, **kw), fn_j(*jargs)


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [16, 32])
def test_mamba2_ssd_matches_sequential_reference(shape, with_state, chunk):
    args = _ssd_inputs(*shape, with_state=with_state)
    (y, st), (wy, wst) = _both(tref.mamba2_ssd, jref.mamba2_ssd, args,
                               chunk=chunk)
    np.testing.assert_allclose(np32(y), np.asarray(wy), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(np32(st), np.asarray(wst), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_ssd_scan_matches_sequential_reference(with_state):
    args = _ssd_inputs(*SSD_SHAPES[0], with_state=with_state)
    (y, st), (wy, wst) = _both(tref.mamba2_ssd_scan, jref.mamba2_ssd, args)
    np.testing.assert_allclose(np32(y), np.asarray(wy), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(np32(st), np.asarray(wst), atol=2e-5,
                               rtol=2e-5)


def _long_chunk_inputs():
    """zamba2's chunk (256) on a 300-step input: dt = softplus(N(0,1)),
    A = -1 (zamba2's a_log init is 0)."""
    x, dt, _, bi, ci, d, _ = _ssd_inputs(1, 300, 2, 8, 16, seed=11)
    return x, dt, -np.ones(2, np.float32), bi, ci, d, None


def test_reference_chunked_ssd_is_nan_at_zamba2_chunk():
    """Pins a fault of the reference (ROADMAP.md Queue 3):
    `mamba2_ssd_chunked` takes exp(cum_t - cum_j) for every pair and then
    multiplies by a triangle; above the diagonal the exponent passes 88
    within a 256-step chunk, and inf * 0 = NaN."""
    args = [None if a is None else jnp.asarray(a)
            for a in _long_chunk_inputs()]
    y, _ = jref.mamba2_ssd_chunked(*args, chunk=256)
    assert np.isnan(np.asarray(y)).any()
    y_seq, _ = jref.mamba2_ssd(*args)
    assert np.isfinite(np.asarray(y_seq)).all()


def test_port_ssd_is_finite_at_zamba2_chunk():
    """The port takes the decay only where j <= t: finite, and equal to
    the sequential reference, at chunk 256."""
    (y, st), (wy, wst) = _both(tref.mamba2_ssd, jref.mamba2_ssd,
                               _long_chunk_inputs(), chunk=256)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    np.testing.assert_allclose(np32(y), np.asarray(wy), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(np32(st), np.asarray(wst), atol=2e-3,
                               rtol=2e-3)


def test_mamba2_ssd_zero_dt_passes_state_through():
    """With dt == 0 the state passes through unchanged and the output is
    its readout C . state plus the D-skip (the reference's
    test_mamba2_decay_property, from a non-zero state)."""
    x, _, a, bi, ci, d, st = _ssd_inputs(1, 16, 2, 4, 8, with_state=True)
    dt = np.zeros((1, 16, 2), np.float32)
    args = [torch.from_numpy(t) for t in (x, dt, a, bi, ci, d, st)]
    y, fs = tref.mamba2_ssd(*args[:6], args[6], chunk=8)
    assert torch.equal(fs, args[6])
    inter = torch.einsum("bhpn,btn->bthp", args[6], args[4])
    torch.testing.assert_close(y, inter + args[5][None, None, :, None]
                               * args[0], atol=1e-5, rtol=1e-5)


def test_dispatcher_takes_plain_versions_on_cpu():
    """CPU tensors take the plain versions and launch no kernel."""
    q, k, v = map(torch.from_numpy, _attn_inputs(*ATTN_SHAPES[0]))
    before = (fa_kernel.launches["flash_attention"],
              ssd_kernel.launches["mamba2_ssd"])
    assert torch.equal(ops.flash_attention(q, k, v),
                       tref.attention(q, k, v))
    args = [torch.from_numpy(a) for a in _ssd_inputs(*SSD_SHAPES[1])[:6]]
    for g, w in zip(ops.mamba2_ssd(*args, chunk=32),
                    tref.mamba2_ssd(*args, chunk=32)):
        assert torch.equal(g, w)
    assert before == (fa_kernel.launches["flash_attention"],
                      ssd_kernel.launches["mamba2_ssd"])


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never runs the plain
    version."""
    q, k, v = map(torch.from_numpy, _attn_inputs(*ATTN_SHAPES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, k, v)
    args = [torch.from_numpy(a) for a in _ssd_inputs(*SSD_SHAPES[1])[:6]]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.mamba2_ssd(*args)
