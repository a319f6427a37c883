"""The MoE's backward in the port (`repro_torch.models.moe`): the f32-result
product's gradient (`MatmulF32`) and the dispatch's fixed-order backward
(`Dispatch`), against the reference and against autograd of the plain
gather, on the CPU.

Inputs are drawn with numpy from fixed seeds.  Tolerances, each with its
reason:
  * `MatmulF32` in bf16 against `jax.vjp` of the reference's
    `_swiglu_grouped` (and of its shared expert's 2-D products): every
    element of every operand's gradient within one bf16 step of the
    reference's at that element's magnitude.  Both form the same f32 sums
    of exact products in other orders and round once to bf16, so a sum
    near a rounding boundary lands one step away, and a step in h's
    gradient moves the gate and up gradients by at most one more rounding;
  * the dispatch backward against autograd of `x_pad[buf_tok]` (an
    accumulating `index_put_` in slot order): in f32 within 1e-6 relative
    to max(|g|, 1) (k terms summed in another order); in f64 on
    cotangents that are f32 values, bit for bit (a sum of at most four f32
    values of these magnitudes is exact in f64, in any order);
  * bf16 `moe_apply`'s gradients against `jax.vjp` of the reference's:
    relative L2 within 2e-2 per tensor (bf16 roundings of the same f32
    sums, in other orders, through the SwiGLU's backward);
  * the port's bf16 gradient twice: the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models.weights import params_from_numpy
from torch_port_util import on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")


def _bf16_steps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in bf16 steps at |want| (the spacing of
    bf16 numbers there: 2^(floor(log2 |want|) - 7))."""
    got, want = got.double(), want.double()
    step = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
                      - 7)
    return float(((got - want).abs() / step).max())


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t(a, grad=True):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16(
        ).requires_grad_(grad)


def _j2t(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


@pytest.mark.parametrize("seed", [0, 1])
def test_swiglu_grouped_grad_matches_reference_vjp(seed):
    """The grouped SwiGLU's three products through `MatmulF32` in bf16:
    the gradient in the tokens and in each expert stack against the
    reference's transpose rule (`jax.vjp` of its `_swiglu_grouped`)."""
    rng = np.random.default_rng(seed)
    e, c, d, f = 4, 24, 64, 96
    xg = rng.standard_normal((e, c, d))
    ws = [rng.standard_normal(s) / 8 for s in ((e, d, f), (e, d, f),
                                               (e, f, d))]
    ct = rng.standard_normal((e, c, d))
    out, vjp = jax.vjp(jmoe._swiglu_grouped, _j(xg), *map(_j, ws))
    want = vjp(_j(ct))
    ts = [_t(xg)] + [_t(w) for w in ws]
    y = tmoe._swiglu_grouped(*ts)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y.detach().float(), _j2t(out))
    got = torch.autograd.grad(y, ts, _t(ct, False))
    for name, g, w, t in zip(("xg", "w_gate", "w_up", "w_down"), got, want,
                             ts):
        assert g.dtype == t.dtype == torch.bfloat16, name
        assert _bf16_steps(g, _j2t(w)) <= 1.0, name


def test_shared_expert_products_grad_matches_reference_vjp():
    """The 2-D products (the shared expert's) through `MatmulF32` in bf16,
    against `jax.vjp` of the reference's einsums with
    `preferred_element_type=f32`: both operands' gradients of an f32
    cotangent, which is not rounded."""
    rng = np.random.default_rng(2)
    x, w = rng.standard_normal((40, 64)), rng.standard_normal((64, 48)) / 8
    ct = rng.standard_normal((40, 48)).astype(np.float32)

    def ref(a, b):
        return jnp.einsum("td,df->tf", a, b,
                          preferred_element_type=jnp.float32)

    out, vjp = jax.vjp(ref, _j(x), _j(w))
    want = vjp(jnp.asarray(ct))
    tx, tw = _t(x), _t(w)
    y = tmoe._mm_f32(tx, tw)
    assert y.dtype == torch.float32
    # f32 sums of the same exact products in another order
    err = (y.detach() - _j2t(out)).abs() / _j2t(out).abs().clamp_min(1.0)
    assert float(err.max()) <= 1e-6
    got = torch.autograd.grad(y, (tx, tw), torch.from_numpy(ct))
    for g, wnt in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _bf16_steps(g, _j2t(wnt)) <= 1.0
    # the cotangent kept in f32: rounding it to bf16 first moves the
    # result by more than a step somewhere
    rounded = torch.autograd.grad(tmoe._mm_f32(tx, tw), (tx, tw),
                                  torch.from_numpy(ct).bfloat16().float())
    assert any(_bf16_steps(r, _j2t(wnt)) > 1.0
               for r, wnt in zip(rounded, want))


def _routing(cfg, t, seed):
    """`_moe_body`'s buf_tok [E * C] and slots [T, k] for random routing of
    t tokens at cfg's capacity factor, skewed towards the higher experts
    (which overflow, while the lower ones leave slots empty), and keep
    [T * k]."""
    from repro_torch.models.moe import _route
    logits = torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (t, cfg.n_experts)) + np.linspace(0, 3, cfg.n_experts)
        ).astype(np.float32))
    _, idx, _ = _route(logits, cfg)
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = max(1, int(np.ceil(cfg.capacity_factor * t * k / e)))
    expert_id = idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(expert_id, e)
    pos = onehot.cumsum(0).gather(1, expert_id[:, None])[:, 0] - 1
    keep = pos < cap
    slot = torch.where(keep, expert_id * cap + pos,
                       torch.full_like(pos, e * cap))
    buf_tok = torch.full((e * cap + 1,), t, dtype=torch.long)
    buf_tok[slot] = torch.arange(t).repeat_interleave(k)
    return buf_tok[:-1], slot.view(t, k), keep


@pytest.mark.parametrize("top_k", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dispatch_backward_matches_the_plain_gather(dtype, top_k):
    """capacity factor 0.5, so some assignments drop and some slots stay
    empty: the dispatch's forward is the plain gather's, and its
    backward (k-order sums through the inverse map) equals autograd of the
    plain gather (slot-order accumulation)."""
    cfg = tconfigs.get_reduced("dbrx-132b").replace(
        n_experts=8, moe_top_k=top_k, capacity_factor=0.5)
    t, d = 48, 32
    buf_tok, slots, keep = _routing(cfg, t, seed=top_k)
    assert not bool(keep.all()) and bool((buf_tok == t).any())
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((t, d))).to(dtype)
    # f32 values, so that their f64 sums are exact
    g = torch.from_numpy(rng.standard_normal((buf_tok.numel(), d)).astype(
        np.float32)).to(dtype)
    xa = x.clone().requires_grad_()
    plain = torch.cat([xa, xa.new_zeros(1, d)])[buf_tok]
    (want,) = torch.autograd.grad(plain, xa, g)
    xb = x.clone().requires_grad_()
    got_fwd = tmoe.Dispatch.apply(xb, buf_tok, slots)
    assert torch.equal(got_fwd, plain.detach())
    (got,) = torch.autograd.grad(got_fwd, xb, g)
    assert got.dtype == dtype
    # a token whose every assignment dropped gets a zero gradient
    lost = ~keep.view(t, top_k).any(1)
    assert not bool(got[lost].any())
    if dtype == torch.float64:
        assert torch.equal(got, want)
    else:
        err = (got - want).abs() / want.abs().clamp_min(1.0)
        assert float(err.max()) <= 1e-6


def test_dispatch_backward_sums_in_k_order_in_the_cotangents_dtype():
    """bf16: the gradient is each token's k slot gradients added in k
    order in bf16 (the reference's scatter-add is in x's dtype), a dropped
    assignment adding zero; bit for bit."""
    cfg = tconfigs.get_reduced("dbrx-132b").replace(
        n_experts=8, moe_top_k=4, capacity_factor=0.5)
    t, d = 48, 32
    buf_tok, slots, _ = _routing(cfg, t, seed=7)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((t, d))).bfloat16(
        ).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((buf_tok.numel(), d))).bfloat16()
    (got,) = torch.autograd.grad(tmoe.Dispatch.apply(x, buf_tok, slots), x, g)
    g_pad = torch.cat([g, torch.zeros(1, d, dtype=torch.bfloat16)])
    want = g_pad[slots[:, 0]]
    for j in range(1, 4):
        want = want + g_pad[slots[:, j]]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _bf16_pair(seed=1):
    jcfg = jconfigs.get_reduced("dbrx-132b").replace(dtype="bfloat16")
    tcfg = tconfigs.get_reduced("dbrx-132b").replace(dtype="bfloat16")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    jp = jax.tree.map(lambda t: t[0], jparams["moe"])["moe"]
    return jcfg, tcfg, jp, params_from_numpy(tcfg, tree).moe[0].moe


@pytest.mark.parametrize("factor", [0.5, 1.25])
def test_moe_apply_bf16_gradients_match_reference(factor):
    """The reduced dbrx MoE layer in bf16, `moe_apply` through the
    Function products and the dispatch: the gradient of a fixed cotangent
    in x and in every weight against `jax.vjp` of the reference's
    `moe_apply`, with drops (0.5) and at the configs' factor; two port
    calls give the same bits."""
    jcfg, tcfg, jp, tp = _bf16_pair()
    jcfg, tcfg = (c.replace(capacity_factor=factor) for c in (jcfg, tcfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, tcfg.d_model))
    ct = rng.standard_normal((2, 16, tcfg.d_model))
    names = ("router", "w_gate", "w_up", "w_down")

    def ref(xx, *ws):
        return jmoe.moe_apply(dict(zip(names, ws)), xx, jcfg)[0]

    _, vjp = jax.vjp(ref, _j(x), *(jp[n] for n in names))
    want = vjp(_j(ct))
    tp.requires_grad_(True)
    try:
        leaves = [getattr(tp, n) for n in names]
        runs = []
        for _ in range(2):
            xt = _t(x)
            out, _ = tmoe.moe_apply(tp, xt, tcfg)
            runs.append(torch.autograd.grad(out, [xt] + leaves,
                                            _t(ct, False)))
    finally:
        tp.requires_grad_(False)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    for name, g, w in zip(("x",) + names, runs[0], want):
        w = _j2t(w).double()
        assert g.dtype == torch.bfloat16, name
        gap = float((g.double() - w).norm() / w.norm())
        assert gap <= 2e-2, (name, gap)
