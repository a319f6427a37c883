"""The port's RWKV6 against the JAX reference, on the CPU.

`repro_torch.kernels.ref.rwkv6_wkv` (the chunked plain version: what the
dispatcher runs for CPU tensors, and what the CUDA kernel is held against
on the card by tests/test_torch_cuda.py) and `rwkv6_wkv_scan` (the
sequential oracle) against the reference's `rwkv6_wkv` (sequential) and
`rwkv6_wkv_chunked`, on the same numpy inputs; one port `rwkv6_apply`
layer against the reference's, prefill and decode, with the same weights;
the overflow of the reference's chunked form under strong decay, which
the port does not share; and a plain emulation of the CUDA kernel's own
arithmetic (64-step chunks, states handed from chunk to chunk,
pivot-factored score tile) against the reference.

Tolerances: 2e-4 absolute and relative for the WKV, the reference's own
(tests/test_kernels.py: chunked and sequential sums differ in order over
up to 130 steps); 1e-4 relative to max(|x|, 1) for the layer
(tests/test_torch_models.py's bound: f32 matmuls summed in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.models import rwkv as jrwkv
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_wkv as wkv_kernel
from repro_torch.models import rwkv as trwkv
from repro_torch.models.weights import params_from_numpy
from torch_port_util import np32, on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

# (b, s, h, k, v): tests/test_kernels.py's RWKV shapes
WKV_SHAPES = [(2, 130, 3, 16, 16), (1, 64, 2, 32, 32), (1, 33, 1, 8, 8)]
TOL = 2e-4


def _wkv_inputs(b, s, h, kd, vd, seed=0, with_state=False, log_w=None):
    """r, k, v, u ~ N(0, 1); w = exp(-exp(N(0, 0.5) - 1)), log w in about
    [-1, -0.1] as at random init, or the constant exp(log_w)."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, s, h, kd)).astype(np.float32)
    k = rng.standard_normal((b, s, h, kd)).astype(np.float32)
    v = rng.standard_normal((b, s, h, vd)).astype(np.float32)
    if log_w is None:
        w = np.exp(-np.exp(0.5 * rng.standard_normal((b, s, h, kd)) - 1.0))
    else:
        w = np.full((b, s, h, kd), np.exp(log_w))
    u = rng.standard_normal((h, kd)).astype(np.float32)
    st = ((0.1 * rng.standard_normal((b, h, kd, vd))).astype(np.float32)
          if with_state else None)
    return r, k, v, w.astype(np.float32), u, st


def _both(args):
    return ([None if a is None else torch.from_numpy(a) for a in args],
            [None if a is None else jnp.asarray(a) for a in args])


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_wkv_chunked_matches_reference(shape, with_state, chunk):
    """The port's chunked form against the reference's sequential
    recurrence and its chunked form at the same chunk."""
    targs, jargs = _both(_wkv_inputs(*shape, with_state=with_state))
    out, st = tref.rwkv6_wkv(*targs, chunk=chunk)
    assert out.shape == targs[2].shape and st.dtype == torch.float32
    want_out, want_st = jref.rwkv6_wkv(*jargs)
    _close(out, want_out)
    _close(st, want_st)
    chunk_out, chunk_st = jref.rwkv6_wkv_chunked(*jargs, chunk=chunk)
    _close(out, chunk_out)
    _close(st, chunk_st)


@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_scan_matches_reference(shape, with_state):
    targs, jargs = _both(_wkv_inputs(*shape, seed=1, with_state=with_state))
    out, st = tref.rwkv6_wkv_scan(*targs)
    want_out, want_st = jref.rwkv6_wkv(*jargs)
    _close(out, want_out)
    _close(st, want_st)


def test_wkv_rounds_once_to_the_input_dtype():
    """bf16 inputs: out in bf16, the f32 sum (bonus included) rounded
    once, the state in f32."""
    targs, _ = _both(_wkv_inputs(1, 40, 2, 16, 16, seed=2, with_state=True))
    bf = [t.to(torch.bfloat16) for t in targs[:3]] + [targs[3],
                                                      targs[4].bfloat16(),
                                                      targs[5]]
    out, st = tref.rwkv6_wkv(*bf, chunk=16)
    assert out.dtype == torch.bfloat16 and st.dtype == torch.float32
    f32 = [t.float() for t in bf]
    want, want_st = tref.rwkv6_wkv(*f32, chunk=16)
    assert torch.equal(out, want.to(torch.bfloat16))
    assert torch.equal(st, want_st)


def _strong_decay_inputs():
    """Constant log w = -1.5: one 64-step chunk's log-decays sum to -96."""
    return _wkv_inputs(1, 128, 2, 16, 16, seed=3, log_w=-1.5)


def test_reference_chunked_wkv_is_nan_under_strong_decay():
    """Pins a fault of the reference (ROADMAP.md Queue 3):
    `rwkv6_wkv_chunked` (and the Pallas body) factor the decay as
    exp(cum_{t-1}) exp(-cum_j); at log w = -1.5 exp(-cum_j) passes the f32
    range within a 64-step chunk and inf * 0 gives NaN.  The sequential
    reference is finite."""
    _, jargs = _both(_strong_decay_inputs())
    out, _ = jref.rwkv6_wkv_chunked(*jargs, chunk=64)
    assert np.isnan(np.asarray(out)).any()
    seq, _ = jref.rwkv6_wkv(*jargs)
    assert np.isfinite(np.asarray(seq)).all()


@pytest.mark.parametrize("log_w", [-1.5, -3.0])
def test_port_wkv_is_finite_under_strong_decay(log_w):
    """The port takes the decays relatively: finite, and equal to the
    sequential oracle and to the reference's sequential recurrence."""
    args = _wkv_inputs(1, 128, 2, 16, 16, seed=3, log_w=log_w,
                       with_state=True)
    targs, jargs = _both(args)
    out, st = tref.rwkv6_wkv(*targs, chunk=64)
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    seq_out, seq_st = tref.rwkv6_wkv_scan(*targs)
    _close(out, seq_out)
    _close(st, seq_st)
    want_out, want_st = jref.rwkv6_wkv(*jargs)
    _close(out, want_out)
    _close(st, want_st)


def test_dispatcher_takes_plain_wkv_on_cpu():
    """CPU tensors take the plain version and launch no kernel; the
    kernel's wrapper refuses them."""
    targs, _ = _both(_wkv_inputs(*WKV_SHAPES[1], with_state=True))
    before = wkv_kernel.launches["rwkv6_wkv"]
    for g, w in zip(ops.rwkv6_wkv(*targs, chunk=32),
                    tref.rwkv6_wkv(*targs, chunk=32)):
        assert torch.equal(g, w)
    assert wkv_kernel.launches["rwkv6_wkv"] == before
    with pytest.raises(ValueError, match="CUDA"):
        wkv_kernel.rwkv6_wkv(*targs)


@pytest.mark.parametrize("s, nc", [(1, 1), (64, 1), (65, 2)])
def test_wkv_scratch_holds_one_state_per_chunk(s, nc):
    """The kernel's scratch: a [K, V] f32 state and a [K] f32 decay for
    each 64-step chunk, ceil(S / 64) chunks, nothing filled."""
    ds, clast = wkv_kernel.scratch(2, s, 3, 5, 7, "cpu")
    assert ds.shape == (2, 3, nc, 5, 7) and clast.shape == (2, 3, nc, 5)
    assert ds.dtype == clast.dtype == torch.float32
    assert ds.is_contiguous() and clast.is_contiguous()


# --------------------------------------------------------------------------
# One layer, the reduced config, the reference's weights
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def layer(on_cpu):
    """(reference cfg, port cfg, reference layer params, port layer)."""
    cfg = jconfigs.get_reduced("rwkv6-3b")
    tcfg = tconfigs.get_reduced("rwkv6-3b")
    tree = jax.tree.map(np.asarray,
                        jmodel.init_params(cfg, jax.random.PRNGKey(5)))
    jp = {k: jnp.asarray(v[0]) for k, v in tree["layers"].items()}
    return cfg, tcfg, jp, params_from_numpy(tcfg, tree).layers[0]


def _hidden(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _scaled_close(got, want, tol=1e-4, what=""):
    got, want = np32(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0))
    assert err <= tol, f"{what}: {err} > {tol}"


def _caches(cfg, tcfg, b, seed):
    """The same non-zero caches for both packages, in the activation
    dtype (f32 in the reduced config)."""
    rng = np.random.default_rng(seed)
    shapes = trwkv.rwkv6_cache_shapes(tcfg, b)
    arrs = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}
    return ({k: jnp.asarray(a) for k, a in arrs.items()},
            {k: torch.from_numpy(a.copy()) for k, a in arrs.items()})


@pytest.mark.parametrize("with_cache", [False, True])
def test_layer_prefill_matches_reference(layer, with_cache):
    cfg, tcfg, jp, tp = layer
    x = _hidden(cfg, 2, 19, seed=6)
    jc, tc = _caches(cfg, tcfg, 2, seed=7) if with_cache else (None, None)
    want, wcache = jrwkv.rwkv6_apply(jp, jnp.asarray(x), cfg, cache=jc)
    got, gcache = trwkv.rwkv6_apply(tp, torch.from_numpy(x), tcfg, cache=tc)
    _scaled_close(got, want, what="prefill")
    if with_cache:
        for k in wcache:
            _scaled_close(gcache[k], wcache[k], what=f"cache {k}")


def test_layer_decode_matches_reference(layer):
    cfg, tcfg, jp, tp = layer
    jc, tc = _caches(cfg, tcfg, 2, seed=8)
    for step in range(3):
        x = _hidden(cfg, 2, 1, seed=10 + step)
        want, jc = jrwkv.rwkv6_apply(jp, jnp.asarray(x), cfg, cache=jc,
                                     decode=True)
        got, tc = trwkv.rwkv6_apply(tp, torch.from_numpy(x), tcfg, cache=tc,
                                    decode=True)
        _scaled_close(got, want, what=f"decode {step}")
        for k in jc:
            _scaled_close(tc[k], jc[k], what=f"cache {k} at {step}")


def test_cache_shapes_match_reference():
    for get in ("get", "get_reduced"):
        cfg = getattr(tconfigs, get)("rwkv6-3b")
        want = {k: d.shape for k, d in jrwkv.rwkv6_cache_defs(
            getattr(jconfigs, get)("rwkv6-3b"), 3).items()}
        assert trwkv.rwkv6_cache_shapes(cfg, 3) == want


# --------------------------------------------------------------------------
# The CUDA kernel's arithmetic, emulated on the CPU
# --------------------------------------------------------------------------
def _kernel_emulation(r, k, v, w, u, state=None):
    """What `csrc/rwkv6_wkv.cu` computes, step for step, in plain f32:
    log2 running sums per 64-step chunk; phase 1 writes each chunk's
    state increment dS and its total log2 decay; phase 2 scans the chunk
    states S_c; phase 3 builds the [64, 64] score tile with exponentials
    per (t, j, k) only inside the four 16-step diagonal sub-blocks (the
    bonus on their diagonal) and pivot-factored products elsewhere, and
    reads out (r_t 2^{c_{t-1}}) . S_c + A v.  Every exponent is <= 0."""
    C, L = 64, 16
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    nc = -(-s // C)
    pad = nc * C - s

    def chunks(x, value=0.0):          # [B,S,H,E] -> [B,H,NC,C,E]
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad),
                                    value=value)
        return x.reshape(b, nc, C, h, x.shape[-1]).permute(0, 3, 1, 2, 4)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    c = torch.cumsum(torch.log2(chunks(w, 1.0).clamp_min(1e-30)), dim=3)
    clast = c[..., -1, :]                                    # [B,H,NC,K]
    # phase 1: dS_c = sum_j (k_j 2^{c_last - c_j}) v_j^T
    ds = torch.einsum("bhnjk,bhnjv->bhnkv",
                      kc * torch.exp2(clast[..., None, :] - c), vc)
    # phase 2: S_{c+1} = 2^{c_last} o S_c + dS_c
    st = (torch.zeros(b, h, kd, vd) if state is None else state.float())
    starts = []
    for n in range(nc):
        starts.append(st)
        st = torch.exp2(clast[:, :, n])[..., None] * st + ds[:, :, n]
    s_c = torch.stack(starts, 2)                             # [B,H,NC,K,V]
    # phase 3: the row pivot of block I is step 16 I - 1 (c_{-1} = 0), the
    # column pivot of block J its last step 16 J + 15
    cprev = torch.nn.functional.pad(c[..., :-1, :], (0, 0, 1, 0))
    blk = torch.arange(C) // L
    c_row = cprev[..., blk * L, :]                           # c_{16 I - 1}
    rt = rc * torch.exp2(cprev - c_row)
    kt = kc * torch.exp2(c[..., blk * L + L - 1, :] - c)
    a = torch.zeros(b, h, nc, C, C)
    uf = u.float()[None, :, None, None, :]
    for i in range(C // L):
        ti = slice(i * L, (i + 1) * L)
        for j in range(i):
            tj = slice(j * L, (j + 1) * L)
            d = torch.exp2(c[..., i * L - 1, :] - c[..., j * L + L - 1, :])
            a[..., ti, tj] = torch.einsum("bhntk,bhnk,bhnjk->bhntj",
                                          rt[..., ti, :], d, kt[..., tj, :])
        low = torch.ones(L, L, dtype=torch.bool).tril(-1)[..., None]
        expo = torch.where(low, cprev[..., ti, None, :] - c[..., None, ti, :],
                           -torch.inf)
        blk_a = torch.einsum("bhntk,bhnjk,bhntjk->bhntj", rc[..., ti, :],
                             kc[..., ti, :], torch.exp2(expo))
        bonus = (rc[..., ti, :] * uf * kc[..., ti, :]).sum(-1)
        a[..., ti, ti] = blk_a + torch.diag_embed(bonus)
    rhat = rt * torch.exp2(c_row)                            # r_t 2^{c_{t-1}}
    out = (torch.einsum("bhntk,bhnkv->bhntv", rhat, s_c)
           + torch.einsum("bhntj,bhnjv->bhntv", a, vc))
    out = out.permute(0, 2, 3, 1, 4).reshape(b, nc * C, h, vd)[:, :s]
    return out.to(r.dtype), st


@pytest.mark.parametrize("shape", WKV_SHAPES + [
    (1, s, 2, 8, 8) for s in (1, 16, 17, 63, 64, 65, 200)])
@pytest.mark.parametrize("with_state", [False, True])
def test_kernel_emulation_matches_reference(shape, with_state):
    """The kernel's arithmetic against the reference's sequential
    recurrence, at 2e-4."""
    targs, jargs = _both(_wkv_inputs(*shape, seed=4, with_state=with_state))
    out, st = _kernel_emulation(*targs)
    assert out.shape == targs[2].shape and st.dtype == torch.float32
    want_out, want_st = jref.rwkv6_wkv(*jargs)
    _close(out, want_out)
    _close(st, want_st)


@pytest.mark.parametrize("log_w", [-1.5, -3.0, -69.0])
def test_kernel_emulation_is_finite_under_strong_decay(log_w):
    """Every exponent the kernel takes is <= 0: finite, and equal to the
    port's sequential oracle where the reference's chunked form is NaN."""
    targs, _ = _both(_wkv_inputs(1, 200, 2, 16, 16, seed=3, log_w=log_w,
                                 with_state=True))
    out, st = _kernel_emulation(*targs)
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    seq_out, seq_st = tref.rwkv6_wkv_scan(*targs)
    _close(out, seq_out)
    _close(st, seq_st)

