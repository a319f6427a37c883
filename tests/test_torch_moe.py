"""The port's MoE and MTP (`repro_torch.models.moe`, `models/model.py`)
against `repro.models.moe` and `repro.models.model`, on the CPU.

The reference's weights are carried across by `weights.params_from_numpy`
and both sides take the same numpy inputs.  Tolerances, in f32: routing
indices equal; routing weights and the aux loss within 1e-6 (a softmax or
sigmoid of the same f32 logits, a D-term dot product summed in another
order); `moe_apply`'s output within 1e-5 relative to max(|x|, 1) (f32
matmuls summed in other orders, and the combine sums a token's k slot
outputs in k order where the reference scatter-adds in slot order); the
loss terms within 1e-5 and each gradient within 1e-4 in relative L2 (a
few layers of f32 matmuls and their backward).  In bf16 (reduced widths),
`moe_apply` within 4e-3 relative to max(|x|, 1): both sides form the same
f32 sums of exact bf16 products in other orders, and a sum that lands on
the other side of a bf16 rounding boundary moves that result by one bf16
step (2^-8 relative).  Rounding the gate and up products to bf16, as a
bf16 matmul would, puts the output 1.2e-2 to 1.6e-2 away, so the bound
pins the f32 products.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import weights
from repro_torch.models.weights import params_from_numpy
from torch_port_util import np32, on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

MOE_ARCHS = ["dbrx-132b", "deepseek-v3-671b"]


def _scaled_err(got, want) -> float:
    got, want = np32(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def _pair(arch, dtype="float32", seed=1):
    """(reference cfg, port cfg, reference params, port model)."""
    jcfg = jconfigs.get_reduced(arch).replace(dtype=dtype)
    tcfg = tconfigs.get_reduced(arch).replace(dtype=dtype)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tcfg, tree)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request, on_cpu):
    return _pair(request.param)


def _moe_layer(jparams, tparams):
    """The first MoE layer's parameters on both sides."""
    return (jax.tree.map(lambda t: t[0], jparams["moe"])["moe"],
            tparams.moe[0].moe)


def _x(cfg, b=2, s=16, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)      # softmax, sigmoid
def test_route_matches_reference(arch):
    cfg = tconfigs.get_reduced(arch)
    logits = np.random.default_rng(0).standard_normal(
        (64, cfg.n_experts)).astype(np.float32)
    jw, jidx, jaux = jmoe._route(jnp.asarray(logits), cfg)
    tw, tidx, taux = tmoe._route(torch.from_numpy(logits), cfg)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_ties_break_to_the_lower_expert(arch):
    """A zero router: every score ties, and both sides pick experts 0 ..
    k-1 for every token, best first, with equal weights."""
    cfg = tconfigs.get_reduced(arch)
    logits = np.zeros((5, cfg.n_experts), np.float32)
    jw, jidx, jaux = jmoe._route(jnp.asarray(logits), cfg)
    tw, tidx, taux = tmoe._route(torch.from_numpy(logits), cfg)
    want = np.tile(np.arange(cfg.moe_top_k), (5, 1))
    assert np.array_equal(np.asarray(jidx), want)
    assert np.array_equal(tidx.numpy(), want)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_route_aux_near_one_for_uniform_router():
    """The twin of tests/test_models.py's: E * sum f_i P_i is about 1
    under near-uniform routing."""
    cfg = tconfigs.get_reduced("dbrx-132b")
    g = torch.Generator().manual_seed(4)
    logits = 1e-4 * torch.randn(4096, 8, generator=g)
    _, _, aux = tmoe._route(logits, cfg)
    assert 0.9 < float(aux) < 1.3


# --------------------------------------------------------------------------
# moe_apply
# --------------------------------------------------------------------------
def _drops(p, x, cfg):
    """moe_apply's output, aux and its (idx, keep) as the observer saw
    them."""
    seen = []
    with tmoe.observe(lambda idx, keep, cap: seen.append((idx, keep, cap))):
        out, aux = tmoe.moe_apply(p, x, cfg)
    assert len(seen) == 1
    return out, aux, seen[0]


def _reference_keep(idx: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """The reference's drop rule, token-major over the [T, k] assignments:
    an assignment is kept while its expert has fewer than `cap` earlier
    ones."""
    seen = np.zeros(n_experts, int)
    keep = np.zeros(idx.size, bool)
    for i, e in enumerate(idx.reshape(-1)):
        keep[i] = seen[e] < cap
        seen[e] += 1
    return keep.reshape(idx.shape)


@pytest.mark.parametrize("factor", [0.25, 1.25, 16.0])
def test_moe_apply_matches_reference(pair, factor):
    """0.25 drops most assignments, 1.25 (the configs') some, 16 none."""
    jcfg, tcfg, jparams, tparams = pair
    jcfg, tcfg = (c.replace(capacity_factor=factor) for c in (jcfg, tcfg))
    jp, tp = _moe_layer(jparams, tparams)
    x = _x(tcfg)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    got, taux, (idx, keep, cap) = _drops(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32
    assert _scaled_err(got, want) <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-6
    assert np.array_equal(keep.numpy(), _reference_keep(
        idx.numpy(), tcfg.n_experts, cap))
    dropped = int((~keep).sum())
    if factor == 0.25:
        assert dropped > keep.numel() // 2
    if factor == 16.0:
        assert dropped == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_bf16_matches_reference(arch):
    """bf16 weights and activations at reduced widths (f32 router logits,
    f32 gate and up products, the weighting in bf16, an f32 combine):
    within 4e-3 of the reference in bf16, with the same routing as the
    reference's f32 logits give."""
    jcfg, tcfg, jparams, tparams = _pair(arch, "bfloat16")
    assert tparams.moe[0].moe.w_gate.dtype == torch.bfloat16
    jp, tp = _moe_layer(jparams, tparams)
    x = _x(tcfg)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want, jaux = jmoe.moe_apply(jp, xj, jcfg)
    got, taux, (idx, keep, cap) = _drops(
        tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert got.dtype == torch.bfloat16
    assert _scaled_err(got.float(), np.asarray(want, np.float32)) <= 4e-3
    assert abs(float(taux) - float(jaux)) <= 1e-6
    logits = (xj.reshape(-1, jcfg.d_model).astype(jnp.float32)
              @ jp["router"].astype(jnp.float32))
    _, jidx, _ = jmoe._route(logits, jcfg)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))


def test_moe_capacity_drops_are_bounded():
    """The twin of tests/test_models.py's: with a generous capacity factor
    nothing drops, so doubling it changes nothing."""
    cfg = tconfigs.get_reduced("dbrx-132b")
    model = tmodel.init_params(cfg, seed=2)
    p = model.moe[0].moe
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator(
        ).manual_seed(3))
    y1, _ = tmoe.moe_apply(p, x, cfg.replace(capacity_factor=8.0))
    y2, _ = tmoe.moe_apply(p, x, cfg.replace(capacity_factor=16.0))
    torch.testing.assert_close(y1, y2, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_combine_is_order_fixed(arch):
    """Two calls on the same inputs give the same bits (the combine sums a
    token's slot outputs in a fixed order, with no scatter-add)."""
    _, tcfg, _, tparams = _pair(arch)
    p = tparams.moe[0].moe
    x = torch.from_numpy(_x(tcfg, seed=5))
    cfg = tcfg.replace(capacity_factor=0.5)
    a, aux_a = tmoe.moe_apply(p, x, cfg)
    b, aux_b = tmoe.moe_apply(p, x, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_observe_removes_its_observer():
    _, tcfg, _, tparams = _pair("dbrx-132b")
    seen = []
    with tmoe.observe(lambda *a: seen.append(a)):
        tmoe.moe_apply(tparams.moe[0].moe, torch.zeros(1, 2, tcfg.d_model),
                       tcfg)
    tmoe.moe_apply(tparams.moe[0].moe, torch.zeros(1, 2, tcfg.d_model), tcfg)
    assert len(seen) == 1 and not tmoe._OBSERVERS


# --------------------------------------------------------------------------
# the whole model: segments, loss with aux and MTP, gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_segments_match_reference(arch):
    for get in ("get", "get_reduced"):
        jsegs = jmodel.model_segments(getattr(jconfigs, get)(arch))
        tsegs = tmodel.model_segments(getattr(tconfigs, get)(arch))
        assert [(s.name, s.n_layers, s.kind, dataclasses.asdict(s.cfg))
                for s in tsegs] == [
            (s.name, s.n_layers, s.kind, dataclasses.asdict(s.cfg))
            for s in jsegs]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_count_active_params_matches_reference(arch):
    for get in ("get", "get_reduced"):
        cfg = getattr(tconfigs, get)(arch)
        assert tmodel.count_active_params(cfg) \
            == jmodel.count_active_params(getattr(jconfigs, get)(arch))


def test_count_active_params_of_dense_archs():
    for arch in ("qwen3-14b", "minicpm3-4b"):
        cfg = tconfigs.get(arch)
        assert tmodel.count_active_params(cfg) \
            == jmodel.count_active_params(jconfigs.get(arch))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_tree_maps_onto_the_port(arch):
    """The reference's full parameter tree (shapes only) and the port's
    model at published widths, stacked as the reference stacks it: the
    same leaves with the same shapes (the layout `params_from_numpy`
    loads)."""
    cfg = tconfigs.get(arch)
    want = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jmodel.abstract_params(jconfigs.get(arch)))
    got = jax.tree_util.tree_map(
        lambda t: tuple(t.shape), weights.like_from_named(
            dict(tmodel.LM(cfg, "meta").named_parameters())))
    assert got == want


def test_params_from_numpy_refuses_a_moe_tree_that_does_not_fit():
    cfg = tconfigs.get_reduced("deepseek-v3-671b")
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        jconfigs.get_reduced("deepseek-v3-671b"), jax.random.PRNGKey(0)))
    stray = jax.tree.map(lambda a: a, tree)
    stray["moe"]["moe"]["bias"] = np.zeros((2, 4), np.float32)
    with pytest.raises(ValueError, match="moe/moe/bias"):
        params_from_numpy(cfg, stray)
    missing = jax.tree.map(lambda a: a, tree)
    del missing["moe"]["moe"]["shared"]["w_gate"]
    with pytest.raises(KeyError, match="moe/moe/shared/w_gate"):
        params_from_numpy(cfg, missing)
    no_mtp = {k: v for k, v in tree.items() if k != "mtp"}
    with pytest.raises(KeyError, match="mtp"):
        params_from_numpy(cfg, no_mtp)


def _batch(cfg, b=2, s=12, seed=6):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def test_loss_and_gradients_match_reference(pair):
    """loss_fn (CE, the MoE aux, and on deepseek the MTP CE) and its
    gradient in every parameter, against `jax.grad` of the reference's."""
    jcfg, tcfg, jparams, tparams = pair
    toks = _batch(tcfg)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {"tokens": jnp.asarray(toks)}, jcfg),
        has_aux=True)(jparams)
    model = tparams.trainable()
    try:
        names, leaves = zip(*model.named_parameters())
        tloss, tmetrics = tmodel.loss_fn(
            model, {"tokens": torch.from_numpy(toks)}, tcfg)
        tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True,
                                     materialize_grads=True)
    finally:
        model.requires_grad_(False)
    assert set(tmetrics) == set(jmetrics)
    assert ("mtp_ce" in tmetrics) == bool(tcfg.mtp_depth)
    for k in jmetrics:
        assert abs(float(tmetrics[k]) - float(jmetrics[k])) <= 1e-5, k
    assert float(tmetrics["aux"]) > 0
    stacked = weights.tree_from_named(dict(zip(names, tgrads)))
    flat = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat) == len(jax.tree_util.tree_leaves(stacked))
    for path, want in flat:
        got = stacked
        for p in path:
            got = got[p.key]
        want = np.asarray(want, np.float64)
        diff = np.linalg.norm(np.asarray(got, np.float64) - want)
        scale = np.linalg.norm(want)
        key = "/".join(p.key for p in path)
        assert diff <= 1e-4 * scale or diff <= 1e-12, (key, diff, scale)


def test_remat_keeps_aux_and_gradients():
    """Recomputing each layer in the backward (the MoE aux returned beside
    x through torch.utils.checkpoint) changes neither the loss terms nor a
    gradient."""
    cfg = tconfigs.get_reduced("deepseek-v3-671b")
    model = tmodel.init_params(cfg, seed=3).trainable()
    toks = torch.from_numpy(_batch(cfg, seed=8))
    out = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        loss, metrics = tmodel.loss_fn(model, {"tokens": toks}, c)
        out[remat] = (metrics, torch.autograd.grad(
            loss, list(model.parameters()), allow_unused=True,
            materialize_grads=True))
    for k in out[False][0]:
        assert torch.equal(out[False][0][k], out[True][0][k]), k
    for a, b in zip(out[False][1], out[True][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_forward_aux_is_the_sum_over_moe_layers(pair):
    jcfg, tcfg, jparams, tparams = pair
    toks = _batch(tcfg, seed=9)
    _, _, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    seen = []
    with tmoe.observe(lambda *a: seen.append(a)):
        _, _, taux = tmodel.forward(tparams,
                                    {"tokens": torch.from_numpy(toks)}, tcfg)
    assert len(seen) == tcfg.n_layers - tcfg.first_k_dense
    assert abs(float(taux) - float(jaux)) <= 1e-6
