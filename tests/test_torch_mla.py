"""MLA attention through the port (`repro_torch.models.attention`) against
`repro.models.attention`, on the CPU.

One block of reduced minicpm3-4b (4 heads, q_lora 32, kv_lora 32, nope
16, rope 8, v 16) with the reference's weights carried across: the
absorbed decode body on seeded inputs, the prefill into a cache longer
than the prompt and the decode steps after it, and the operands the
prefill hands the attention kernel.  Then the absorption identity the
decode rests on, and served prompts on either side of a prefill bucket's
edge.  All f32; 1e-5 relative to max(|x|, 1) where one layer's sums run
in another order, exact where nothing is summed (the caches).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models.weights import load_named, params_from_numpy
from torch_port_util import np32, on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

ARCH = "minicpm3-4b"
TOL = 1e-5


def assert_close_scaled(got, want, tol=TOL, what=""):
    got, want = np32(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0))
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.fixture(scope="module")
def block(on_cpu):
    """(reference cfg, port cfg, layer 0's reference attention weights as
    numpy, the port's MLA block with those weights)."""
    cfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    tree = jax.tree.map(np.asarray,
                        jmodel.init_params(cfg, jax.random.PRNGKey(5)))
    sub = jax.tree.map(lambda a: a[0], tree["layers"]["attn"])
    mla = tattn.MLA(tcfg, torch.float32, "cpu")
    load_named(dict(mla.named_parameters()), sub, "MLA block")
    return cfg, tcfg, sub, mla


def _positions(b, s, start=0):
    pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                          (b, s))
    return jnp.asarray(pos), torch.from_numpy(pos.copy())


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_absorbed_decode_body_matches_reference(pos):
    """Seeded qc, q_rope, new latents, caches full of noise (positions past
    `pos` must not count) and W_uv: the same output and the same caches
    after the write at `pos`."""
    rng = np.random.default_rng(pos)
    b, h, r, rope, v, s = 2, 4, 32, 8, 16, 12
    qc, q_rope = (rng.standard_normal((b, h, n)).astype(np.float32) * 0.3
                  for n in (r, rope))
    c_new = rng.standard_normal((b, r)).astype(np.float32)
    kr_new = rng.standard_normal((b, rope)).astype(np.float32)
    c_kv = rng.standard_normal((b, s, r)).astype(np.float32)
    k_rope = rng.standard_normal((b, s, rope)).astype(np.float32)
    w_uv = rng.standard_normal((r, h, v)).astype(np.float32) * 0.2
    want, want_c, want_kr = jattn._mla_decode_body(
        *(jnp.asarray(a) for a in (qc, q_rope, c_new, kr_new, c_kv, k_rope,
                                   w_uv)), pos, axis_name=None)
    tc, tkr = torch.from_numpy(c_kv.copy()), torch.from_numpy(k_rope.copy())
    got = tattn._mla_decode_body(
        torch.from_numpy(qc), torch.from_numpy(q_rope),
        torch.from_numpy(c_new), torch.from_numpy(kr_new), tc, tkr,
        torch.from_numpy(w_uv), pos)
    assert got.dtype == torch.float32
    assert_close_scaled(got, want, what=f"decode out at {pos}")
    np.testing.assert_array_equal(np32(tc), np.asarray(want_c))
    np.testing.assert_array_equal(np32(tkr), np.asarray(want_kr))


def test_prefill_into_longer_cache_then_decode(block):
    """A 6-token prefill into 16-position caches (the rest stays zero),
    then 4 decode steps: outputs and both caches as the reference's."""
    cfg, tcfg, sub, mla = block
    b, prompt, max_len = 2, 6, 16
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, prompt + 4, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, sub)
    jpos, tpos = _positions(b, prompt)
    shapes = tattn.mla_cache_shapes(tcfg, b, max_len)
    jcache = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    tcache = {k: torch.zeros(s) for k, s in shapes.items()}
    want, jcache = jattn.mla_apply(jp, jnp.asarray(x[:, :prompt]), cfg,
                                   positions=jpos, cache=jcache)
    got, tcache = tattn.mla_apply(mla, torch.from_numpy(x[:, :prompt]),
                                  tcfg, positions=tpos, cache=tcache)
    assert_close_scaled(got, want, what="prefill out")
    for k in shapes:
        assert_close_scaled(tcache[k], jcache[k], what=f"prefill {k}")
        assert not np32(tcache[k])[:, prompt:].any(), k
    for pos in range(prompt, prompt + 4):
        jpos, tpos = _positions(b, 1, pos)
        want, jcache = jattn.mla_apply(
            jp, jnp.asarray(x[:, pos:pos + 1]), cfg, positions=jpos,
            cache=jcache, decode_pos=jnp.int32(pos))
        got, tcache = tattn.mla_apply(
            mla, torch.from_numpy(x[:, pos:pos + 1]), tcfg, positions=tpos,
            cache=tcache, decode_pos=pos)
        assert_close_scaled(got, want, what=f"decode out at {pos}")
        for k in shapes:
            assert_close_scaled(tcache[k], jcache[k],
                                what=f"decode {k} at {pos}")


def test_prefill_hands_the_kernel_contiguous_mla_operands(block,
                                                          monkeypatch):
    """The card's wrapper raises on a strided operand: q and k come whole
    at nope + rope wide, v contiguous at v_head_dim, every head its own."""
    cfg, tcfg, sub, mla = block
    seen = []

    def spy(q, k, v, *, causal=True):
        seen.append((q, k, v, causal))
        return kops.ref.attention(q, k, v, causal=causal)

    monkeypatch.setattr(kops, "flash_attention", spy)
    _, tpos = _positions(1, 7)
    tattn.mla_apply(mla, torch.randn(1, 7, cfg.d_model), tcfg,
                    positions=tpos)
    (q, k, v, causal), = seen
    h, dh = cfg.n_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert causal
    assert q.shape == k.shape == (1, 7, h, dh)
    assert v.shape == (1, 7, h, cfg.v_head_dim)
    assert all(t.is_contiguous() for t in (q, k, v))


def test_absorption_identity(block):
    """(q_nope W_uk^T) . c_kv equals q_nope . k_nope, with k_nope = c_kv
    W_uk: the latent dot the decode takes is the prefill's score."""
    cfg, tcfg, sub, mla = block
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    _, pos = _positions(2, 9)
    nope = tcfg.qk_nope_head_dim
    q_nope, _ = tattn._mla_q(mla, x, tcfg, pos)
    c_kv, _ = tattn._mla_latents(mla, x, tcfg, pos)
    w_uk = mla.w_kv_b[..., :nope]
    k_nope = torch.einsum("btr,rhk->bthk", c_kv, w_uk)
    qc = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)
    latent = torch.einsum("bshr,btr->bsht", qc, c_kv)
    direct = torch.einsum("bshk,bthk->bsht", q_nope, k_nope)
    assert_close_scaled(latent, direct.numpy(), what="qc . c_kv")


@pytest.mark.parametrize("prompt_len", [16, 17])
def test_served_tokens_across_a_bucket_edge(prompt_len):
    """16 tokens fill the first bucket exactly; 17 go to the 32 bucket,
    whose padded rows the prefill writes and the decode overwrites: the
    port's server emits the reference server's tokens either way."""
    jsrv = jserve.LMServer(jconfigs.get_reduced(ARCH), max_len=64, seed=4)
    tsrv = tserve.LMServer(tconfigs.get_reduced(ARCH), max_len=64, seed=4)
    tsrv.params = params_from_numpy(tsrv.cfg,
                                    jax.tree.map(np.asarray, jsrv.params))
    assert tsrv._bucket(prompt_len) == (16 if prompt_len == 16 else 32)
    prompt = np.random.default_rng(prompt_len).integers(
        0, tsrv.cfg.vocab_size, (1, prompt_len)).astype(np.int32)
    want = jsrv.generate(prompt, 5)
    got = tsrv.generate(prompt, 5)
    assert got.tolist() == np.asarray(want).tolist()
