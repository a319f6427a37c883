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

The CUDA SSD kernel is chunk-parallel (each 64-step chunk's state
increment, a scan over the chunks, then each chunk's output with dt and
the decay folded into the masked C B^T tile and the D-skip added before
the one rounding).  `_ssd_kernel_emulation` does that arithmetic in plain
f32 and is held to the sequential oracle: in f32 at 2e-3, and from bf16
inputs with y within 2e-2 + 2e-2 |y| (one rounding of an f32 result to
bf16) and the f32 state within 2e-3 + 2e-3 |s|.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def _ssd_kernel_emulation(x, dt, a, b_in, c_in, d, state=None):
    """The CUDA kernel's arithmetic (`csrc/mamba2_ssd.cu`) in plain f32:
    64-step chunks; each chunk's increment dS = sum_j exp(cum_last -
    cum_j) dt_j x_j B_j^T and its total log decay (phase 1); the scan
    S_{c+1} = exp(cum_last) S_c + dS_c (phase 2); the masked tile
    G[t, j] = (C_t . B_j) exp(cum_t - cum_j) dt_j, its exponential taken
    only where j <= t, and y = exp(cum_t) C_t . S_c + G x + D x summed in
    f32 and rounded to x's dtype once (phase 3)."""
    chunk = ssd_kernel.CHUNK
    bb, s, h, p = x.shape
    n = b_in.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(bb, nc, chunk, h, p)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(bb, nc, chunk, h)
    bf = F.pad(b_in.float(), (0, 0, 0, pad)).reshape(bb, nc, chunk, n)
    cf = F.pad(c_in.float(), (0, 0, 0, pad)).reshape(bb, nc, chunk, n)
    cum = torch.cumsum(dtf * a.float(), dim=2)                 # [B,NC,L,H]
    last = cum[:, :, -1]                                       # [B,NC,H]
    w = torch.exp(last[:, :, None] - cum) * dtf
    ds = torch.einsum("bcjh,bcjhp,bcjn->bchpn", w, xf, bf)
    st = (torch.zeros((bb, h, p, n)) if state is None else state.float())
    starts = []
    for c in range(nc):
        starts.append(st)
        st = torch.exp(last[:, c])[..., None, None] * st + ds[:, c]
    s_c = torch.stack(starts, 1)                               # [B,NC,H,P,N]
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()[..., None]
    diff = cum[:, :, :, None] - cum[:, :, None]                # [B,NC,t,j,H]
    dec = torch.where(tri, diff, -math.inf).exp()
    g = (torch.einsum("bctn,bcjn->bctj", cf, bf)[..., None] * dec
         * dtf[:, :, None])
    y = (torch.exp(cum)[..., None]
         * torch.einsum("bctn,bchpn->bcthp", cf, s_c)
         + torch.einsum("bctjh,bcjhp->bcthp", g, xf)
         + d.float()[:, None] * xf)
    return y.reshape(bb, nc * chunk, h, p)[:, :s].to(x.dtype), st


def _emulation_against_oracle(shape, with_state, dtype):
    """The emulation and the sequential JAX oracle on the same inputs; in
    bf16, x, B, C and D are rounded to bf16 first and the oracle gets the
    rounded values in f32."""
    args = [None if t is None else torch.from_numpy(t)
            for t in _ssd_inputs(*shape, with_state=with_state)]
    if dtype == torch.bfloat16:
        for i in (0, 3, 4, 5):
            args[i] = args[i].to(dtype)
    y, st = _ssd_kernel_emulation(*args)
    wy, wst = jref.mamba2_ssd(*[None if t is None else jnp.asarray(np32(
        t.float())) for t in args])
    assert y.dtype == dtype and st.dtype == torch.float32
    wy, wst = np.asarray(wy), np.asarray(wst)
    if dtype == torch.float32:
        np.testing.assert_allclose(np32(y), wy, atol=2e-3, rtol=2e-3)
    else:
        assert (np.abs(np32(y.float()) - wy) <= 2e-2 + 2e-2 * np.abs(wy)).all()
    np.testing.assert_allclose(np32(st), wst, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("s", [1, 31, 63, 64, 65, 200])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_emulation_matches_sequential_reference(s, with_state,
                                                           dtype):
    """Around the kernel's 64-step chunk: one step, ragged first chunk,
    exactly one chunk, one step into a second, several chunks."""
    _emulation_against_oracle((2, s, 3, 8, 16), with_state, dtype)


@pytest.mark.parametrize("shape", SSD_SHAPES + [(2, 130, 2, 20, 128)])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_emulation_at_reference_shapes(shape, with_state, dtype):
    """tests/test_kernels.py's SSD shapes, and P = 20 with the widest N
    (the card tests' shape)."""
    _emulation_against_oracle(shape, with_state, dtype)


def test_ssd_kernel_emulation_is_finite_under_strong_decay():
    """A = -8: a 64-step chunk's log decays sum to about -550, far below
    where exp(-cum) overflows; every exponent the kernel takes is <= 0, so
    the result is finite and equals the port's sequential recurrence."""
    x, dt, _, bi, ci, d, st = _ssd_inputs(1, 300, 2, 8, 16, seed=13,
                                          with_state=True)
    args = [torch.from_numpy(t) for t in (x, dt, np.full(2, -8.0, np.float32),
                                          bi, ci, d, st)]
    y, fs = _ssd_kernel_emulation(*args)
    assert torch.isfinite(y).all() and torch.isfinite(fs).all()
    wy, wfs = tref.mamba2_ssd_scan(*args)
    torch.testing.assert_close(y, wy, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(fs, wfs, atol=2e-3, rtol=2e-3)


def test_ssd_kernel_emulation_zero_dt():
    """dt = 0: the state passes through exactly, and from a zero state y
    is exactly D x (the D-skip is one product added to an exact zero)."""
    x, _, a, bi, ci, d, st = _ssd_inputs(1, 100, 2, 8, 16, with_state=True)
    args = [torch.from_numpy(t) for t in (x, np.zeros((1, 100, 2),
                                                      np.float32),
                                          a, bi, ci, d, st)]
    _, fs = _ssd_kernel_emulation(*args)
    assert torch.equal(fs, args[6])
    y, fs = _ssd_kernel_emulation(*args[:6], torch.zeros_like(args[6]))
    assert torch.equal(y, args[5][None, None, :, None] * args[0])
    assert torch.equal(fs, torch.zeros_like(args[6]))


def test_ssd_scratch_shapes():
    """One chunk's [P, N] state and total log decay per (b, h, chunk),
    NC = ceil(S / 64)."""
    ds, clast = ssd_kernel.scratch(2, 130, 3, 20, 16, "cpu")
    assert tuple(ds.shape) == (2, 3, 3, 20, 16)
    assert tuple(clast.shape) == (2, 3, 3)
    assert ds.dtype == clast.dtype == torch.float32


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
