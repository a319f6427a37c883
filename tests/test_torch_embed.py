"""The port's embedding input path against the reference, on the CPU.

phi-3-vision-4.2b and musicgen-large take the frontend's embeddings
[B, S, D] (their vision and audio towers are stubs in both packages) with
the labels beside them.  Reduced configs in f32, the reference's weights
carried across by `weights.params_from_numpy`, inputs from a numpy seed.
Forward logits, prefill caches and decode against the reference are in
tests/test_torch_models.py (its ARCHS hold both archs).  Here:
  * cached decode on embeddings against the port's own teacher-forced
    forward, at tests/test_models.py's decode-equivalence tolerance (2e-3
    absolute and relative);
  * loss_fn and every gradient against `jax.grad` of the reference's:
    loss terms within 1e-5, each gradient within 1e-4 relative L2 (f32
    sums in other orders, as tests/test_torch_moe.py);
  * one train step at `accum_steps` 2 against the reference's jitted
    `make_train_step` (loss, grad norm, lr within 1e-5 relative,
    parameters within 2 lr + 1e-6, tests/test_torch_train.py's
    tolerances), and against the port's single-batch step on a batch of
    two equal halves, bit for bit;
  * `train()` on the synthetic pipeline's embeddings stream against the
    reference's loop, and in a fresh interpreter with neither `jax` nor
    `repro` loaded.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import make_pipeline as jmake_pipeline
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models import weights
from repro_torch.optim import AdamWConfig, init_opt_state
from torch_port_util import on_cpu  # noqa: F401
from torch_train_util import numpy_tree, reference_params, start_port_from

pytestmark = pytest.mark.usefixtures("on_cpu")

ARCHS = ["phi-3-vision-4.2b", "musicgen-large"]


def _batch(cfg, b, s, seed):
    """Embeddings [B, S, D] f32 and labels [B, S], from `seed`."""
    rng = np.random.default_rng(seed)
    return {"embeddings": rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s))}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port(arch, jparams):
    return weights.params_from_numpy(tconfigs.get_reduced(arch),
                                     numpy_tree(jparams))


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_decode_on_embeddings_matches_teacher_forced(arch):
    """A 6-position prefill and 4 decode steps, each fed one embedding
    [B, 1, D], against the forward over all 10 positions."""
    cfg = tconfigs.get_reduced(arch)
    model = tmodel.init_params(cfg, seed=1)
    b, prompt, total = 2, 6, 10
    emb = torch.from_numpy(_batch(cfg, b, total, seed=3)["embeddings"])
    full, _, _ = tmodel.forward(model, {"embeddings": emb}, cfg)
    cache = tmodel.init_cache(cfg, b, total)
    _, cache, _ = tmodel.prefill(model, {"embeddings": emb[:, :prompt]}, cfg,
                                 cache)
    for pos in range(prompt, total):
        step, cache = tmodel.decode_step(
            model, {"embeddings": emb[:, pos:pos + 1]}, cfg, cache, pos)
        torch.testing.assert_close(step, full[:, pos], atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """loss_fn on embeddings and labels, and its gradient in every
    parameter, against `jax.grad` of the reference's.  The embedding table
    is in both trees and the loss does not reach it: zero on both sides."""
    jcfg = jconfigs.get_reduced(arch)
    jparams = reference_params(arch, 2)
    batch = _batch(jcfg, 2, 12, seed=6)
    (_, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, _jax(batch), jcfg), has_aux=True)(jparams)
    model = _port(arch, jparams).trainable()
    names, leaves = zip(*model.named_parameters())
    tloss, tmetrics = tmodel.loss_fn(model, _torch(batch), model.cfg)
    tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True,
                                 materialize_grads=True)
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        got = float(tmetrics[k].detach())
        assert abs(got - float(jmetrics[k])) <= 1e-5, k
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
    assert not stacked["embedding"].any()
    assert float(np.abs(jgrads["embedding"]).max()) == 0.0


def _lr(k):
    """The default schedule's lr at step k (warmup over 100 steps)."""
    return 3e-4 * (k + 1) / 100


@pytest.mark.parametrize("arch", ARCHS)
def test_accumulated_step_matches_reference(arch):
    """One AdamW step at accum_steps 2 (musicgen's published value; phi-3
    taken to it) on a batch of 4: the port's microbatch loop against the
    reference's scan; then the port's accumulated step on two equal
    halves against its single-batch step on one, bit for bit ((g + g) / 2
    and (l + l) / 2 are exact)."""
    jcfg = jconfigs.get_reduced(arch).replace(accum_steps=2)
    jparams = reference_params(arch, 0)
    batch = _batch(jcfg, 4, 16, seed=9)
    jopt = jinit_opt_state(jparams, JAdamWConfig())
    jnew, _, jm = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig()))(
        jparams, jopt, _jax(batch))
    model = _port(arch, jparams).trainable()
    tcfg = model.cfg.replace(accum_steps=2)
    topt = init_opt_state(dict(model.named_parameters()), AdamWConfig())
    model, topt, tm = tsteps.make_train_step(tcfg, AdamWConfig())(
        model, topt, _torch(batch))
    for k in ("loss", "grad_norm", "lr", "ce"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want = dict(weights.params_from_numpy(tcfg, numpy_tree(jnew))
                .named_parameters())
    worst = max(float((p.detach() - want[k]).abs().max())
                for k, p in model.named_parameters())
    assert worst <= 2 * _lr(0) + 1e-6

    half = {k: v[:2] for k, v in batch.items()}
    twice = {k: np.concatenate([v, v]) for k, v in half.items()}
    runs = []
    for c, b in ((tcfg, twice), (tcfg.replace(accum_steps=1), half)):
        m = _port(arch, jparams).trainable()
        opt = init_opt_state(dict(m.named_parameters()), AdamWConfig())
        runs.append(tsteps.make_train_step(c, AdamWConfig())(m, opt,
                                                              _torch(b)))
    (m2, o2, met2), (m1, o1, met1) = runs
    assert float(met2["loss"]) == float(met1["loss"])
    assert all(torch.equal(a, b) for a, b in zip(m2.parameters(),
                                                 m1.parameters()))
    assert all(torch.equal(o2["v"][k], o1["v"][k]) for k in o1["v"])


def test_train_follows_reference_on_the_embeddings_stream():
    """The port's `train()` of reduced musicgen at accum_steps 2 on the
    synthetic pipeline's embeddings (f32 [B, S, D]) and labels, against
    the reference's loop on its pipeline (`repro.launch.train.train`
    without the mesh, which fails on this JAX: torch_train_util), from the
    same parameters: 5 steps, losses within 2e-4 relative
    (tests/test_torch_train.py's end-to-end tolerance)."""
    arch, steps, b, s = "musicgen-large", 5, 4, 16
    jcfg = jconfigs.get_reduced(arch).replace(accum_steps=2)
    jparams = reference_params(arch, 0)
    opt_cfg = JAdamWConfig(total_steps=steps)
    pipe = jmake_pipeline("synthetic", vocab_size=jcfg.vocab_size,
                          seq_len=s, global_batch=b, seed=0,
                          embeddings_dim=jcfg.d_model)
    assert pipe.batch(0)["embeddings"].dtype == np.float32
    step = jax.jit(jsteps.make_train_step(jcfg, opt_cfg))
    params, opt, want = jparams, jinit_opt_state(jparams, opt_cfg), []
    for i in range(steps):
        params, opt, m = step(params, opt, _jax(pipe.batch(i)))
        want.append(float(m["loss"]))
    mp = pytest.MonkeyPatch()
    start_port_from(mp, numpy_tree(jparams))
    try:
        got = ttrain.train(arch, steps=steps, batch=b, seq=s,
                           accum_steps=2, log_every=100)
    finally:
        mp.undo()
    np.testing.assert_allclose(got["losses"], want, rtol=2e-4)
    fed = ttrain._to_device(pipe.batch(0), torch.device("cpu"))
    assert fed["embeddings"].dtype == torch.float32
    assert fed["labels"].dtype == torch.long


def test_train_loads_neither_jax_nor_repro_with_embeddings():
    """Reduced phi-3-vision and musicgen (accum_steps 2) through `train()`
    in a fresh interpreter: neither `jax` nor `repro` loads."""
    root = Path(__file__).resolve().parents[1]
    code = f"""
import math, sys
sys.path.insert(0, {str(root / 'src')!r})
from repro_torch import device
device.set_device("cpu")
from repro_torch.launch.train import train
a = train("phi-3-vision-4.2b", steps=2, batch=2, seq=16, log_every=100)
b = train("musicgen-large", steps=2, batch=4, seq=16, accum_steps=2,
          log_every=100)
assert all(math.isfinite(x) for x in a["losses"] + b["losses"])
loaded = sorted(m for m in sys.modules if m in ("jax", "repro")
                or m.startswith("jax.") or m.startswith("repro."))
print("LOADED", loaded)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]


@pytest.mark.parametrize("arch", ARCHS)
def test_servers_take_no_embedding_requests(arch):
    """The reference's LMServer feeds token ids only, so an embedding arch
    cannot be served there; the port's refuses it alike (the forward
    finds no embeddings)."""
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(KeyError, match="embeddings"):
        jserve.LMServer(jconfigs.get_reduced(arch), max_len=16).generate(
            prompt, 2)
    with pytest.raises(KeyError, match="embeddings"):
        tserve.LMServer(tconfigs.get_reduced(arch), max_len=16).generate(
            prompt, 2)
