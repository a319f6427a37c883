"""The port's LM substrate against `repro.models`, on the CPU.

Reduced zamba2-2.7b, starcoder2-3b, rwkv6-3b, qwen3-14b, yi-34b,
minicpm3-4b (MLA), dbrx-132b (MoE), deepseek-v3-671b (MLA, MoE with a
shared expert, MTP), phi-3-vision-4.2b and musicgen-large (embedding
inputs; the reference's ten archs) with the reference's weights carried
across by `weights.params_from_numpy`: forward logits, prefill caches and
four decode steps against the reference on the same inputs (token ids,
or embeddings [B, S, D] for the last two).  Both run in f32;
the tolerance, 1e-4 relative to max(|x|, 1), covers summation order in a
few layers of f32 matmuls (XLA's and PyTorch's CPU kernels sum in other
orders), the chunked SSD at the reduced chunk (32) against the port's
masked form, and the chunked WKV (chunk 64) with its decays factored
(the reference) or relative (the port).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy
from torch_port_util import np32, on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

ARCHS = ["zamba2-2.7b", "starcoder2-3b", "rwkv6-3b", "qwen3-14b",
         "yi-34b", "minicpm3-4b", "dbrx-132b", "deepseek-v3-671b",
         "phi-3-vision-4.2b", "musicgen-large"]
TOL = 1e-4


def assert_close_scaled(got, want, tol=TOL, what=""):
    got, want = np32(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0))
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.fixture(scope="module", params=ARCHS)
def pair(request, on_cpu):
    """(cfg, reference params, port model with the same weights)."""
    cfg = jconfigs.get_reduced(request.param)
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = tconfigs.get_reduced(request.param)
    return cfg, tcfg, jparams, params_from_numpy(tcfg, tree)


def _batch(cfg, b, s, seed=3):
    """The model's input as numpy, from `seed`: token ids [B, S], or for
    an embedding-input arch f32 embeddings [B, S, D]."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return {"embeddings": rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}


def _cut(batch, lo, hi):
    return {k: v[:, lo:hi] for k, v in batch.items()}


def _jax(batch):
    return {k: jax.numpy.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_configs_match_reference():
    for arch in ARCHS:
        for get in ("get", "get_reduced"):
            j = dataclasses.asdict(getattr(jconfigs, get)(arch))
            t = dataclasses.asdict(getattr(tconfigs, get)(arch))
            assert j == t, arch
    assert tconfigs.get_reduced("zamba2-2.7b").activation_dtype \
        == torch.float32
    assert tconfigs.get("zamba2-2.7b").activation_dtype == torch.bfloat16


def test_registry_holds_the_reference_archs():
    assert sorted(tconfigs.ARCH_NAMES) == sorted(jconfigs.ARCH_NAMES)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("phi-3-vision")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    for cfg in (tconfigs.get(arch), tconfigs.get_reduced(arch)):
        assert tmodel.count_params(cfg) == jmodel.count_params(cfg)


def test_forward_logits_match_reference(pair):
    cfg, tcfg, jparams, tparams = pair
    batch = _batch(cfg, 2, 12)
    want, _, _ = jmodel.forward(jparams, _jax(batch), cfg)
    got, _, _ = tmodel.forward(tparams, _torch(batch), tcfg)
    assert got.dtype == torch.float32
    assert_close_scaled(got, want, what=cfg.name)


def test_prefill_caches_and_decode_match_reference(pair):
    cfg, tcfg, jparams, tparams = pair
    b, prompt, total, max_len = 2, 6, 10, 12
    batch = _batch(cfg, b, total, seed=4)
    jcache = jmodel.init_cache(cfg, b, max_len)
    jlog, jcache, _ = jmodel.prefill(
        jparams, _jax(_cut(batch, 0, prompt)), cfg, jcache)
    tcache = tmodel.init_cache(tcfg, b, max_len)
    tlog, tcache, _ = tmodel.prefill(
        tparams, _torch(_cut(batch, 0, prompt)), tcfg, tcache)
    assert_close_scaled(tlog, jlog, what="prefill logits")
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tflat = dict(_flatten(tcache))
    assert len(jleaves) == len(tflat)
    for path, leaf in jleaves:
        key = "/".join(p.key for p in path)
        assert tflat[key].dtype == torch.float32
        assert_close_scaled(tflat[key], leaf, what=f"cache {key}")
    jlast, _ = jsteps.make_prefill_step(cfg)(
        jparams, _jax(_cut(batch, 0, prompt)),
        jmodel.init_cache(cfg, b, max_len))
    tlast, _ = tsteps.make_prefill_step(tcfg)(
        tparams, _torch(_cut(batch, 0, prompt)),
        tmodel.init_cache(tcfg, b, max_len))
    assert_close_scaled(tlast, jlast, what="prefill step logits")
    for pos in range(prompt, total):
        jl, jcache = jmodel.decode_step(
            jparams, _jax(_cut(batch, pos, pos + 1)), cfg, jcache,
            jax.numpy.int32(pos))
        tl, tcache = tmodel.decode_step(
            tparams, _torch(_cut(batch, pos, pos + 1)), tcfg, tcache, pos)
        assert_close_scaled(tl, jl, what=f"decode logits at {pos}")


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, key)
        else:
            yield key, v


def test_params_from_numpy_refuses_a_tree_that_does_not_fit():
    cfg = tconfigs.get_reduced("starcoder2-3b")
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        jconfigs.get_reduced("starcoder2-3b"), jax.random.PRNGKey(0)))
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stray"):
        params_from_numpy(cfg, extra)
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="lm_head"):
        params_from_numpy(cfg, missing)
    deeper = dict(tree, layers=jax.tree.map(
        lambda a: np.concatenate([a, a]), tree["layers"]))
    with pytest.raises(ValueError, match="wholly"):
        params_from_numpy(cfg, deeper)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_reference_rules(arch):
    """The port draws its own weights (a torch.Generator), with the
    reference's per-leaf rules: the same names and shapes as the carried
    tree, ones and zeros where the reference has them, and fan-in scaled
    normals (std within 10% of scale / sqrt(fan_in))."""
    cfg = tconfigs.get_reduced(arch)
    mine = tmodel.init_params(cfg, seed=7)
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        jconfigs.get_reduced(arch), jax.random.PRNGKey(0)))
    carried = params_from_numpy(cfg, tree)
    named = dict(carried.named_parameters())
    for mod in mine.modules():
        for name, d in getattr(mod, "defs", {}).items():
            p = getattr(mod, name)
            if d.init == "ones":
                assert torch.all(p == 1)
            elif d.init == "zeros":
                assert torch.all(p == 0)
            elif d.init == "fan_in" and p.numel() >= 1024:
                fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
                assert abs(float(p.std()) * fan_in ** 0.5 - 1) < 0.1
    assert {k: v.shape for k, v in mine.named_parameters()} \
        == {k: v.shape for k, v in named.items()}
    again = tmodel.init_params(cfg, seed=7)
    assert all(torch.equal(a, b) for a, b in
               zip(mine.parameters(), again.parameters()))
