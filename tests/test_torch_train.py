"""The port's training path against the reference, on the CPU.

Reduced zamba2-2.7b, starcoder2-3b, rwkv6-3b, dbrx-132b and
deepseek-v3-671b (f32; deepseek's with its sigmoid router, shared expert
and MTP loss) with the reference's parameters carried across
(`weights.params_from_numpy`), the
same batches made with numpy, and JAX's jitted `make_train_step` against
the port's.  Tolerances, each with its reason:
  * loss, grad norm and lr: 1e-5 relative.  Both are f32; XLA's and
    PyTorch's CPU kernels sum in other orders.  zamba2's grad norm: 1e-4,
    for the chunked SSD's two factorisations (`GRAD_NORM_REL`);
  * updated parameters: 2 x (the sum of the steps' lr) + 1e-6 absolute.
    AdamW's first steps turn a gradient near 0 into a step of about
    +-lr, so a gradient whose sign differs in its last bits moves a
    parameter up to 2 lr apart at each step;
  * the end-to-end driver (40 steps): the port's per-step losses within
    2e-4 relative of the reference's, from the same parameters and data.
    The parameter drift above, 2 sum(lr) ~ 5e-3 by step 40, moves the
    loss by far less;
  * a run resumed from a checkpoint follows the uninterrupted one within
    1e-6 relative (the restored state is the saved one bit for bit;
    the CPU's BLAS may round differently at other addresses).
The reference's `train()` fails on this JAX (torch_train_util), so its
loop is `torch_train_util.reference_train`.
"""
import collections
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as torch_checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro_torch import configs as tconfigs
from repro_torch.kernels import mamba2_ssd as ssd_kernel
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_wkv as wkv_kernel
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.weights import opt_state_from_numpy, params_from_numpy
from repro_torch.optim import AdamWConfig, init_opt_state
from torch_port_util import np32, on_cpu  # noqa: F401
from torch_train_util import (numpy_tree, reference_params, reference_train,
                              start_port_from)

pytestmark = pytest.mark.usefixtures("on_cpu")

ARCHS = ["zamba2-2.7b", "starcoder2-3b", "rwkv6-3b", "dbrx-132b",
         "deepseek-v3-671b"]
REL = 1e-5


@functools.lru_cache(maxsize=None)
def _jstep(arch):
    """The reference's jitted train step for reduced `arch` (default
    AdamW), built once, so that its compilation is shared by the tests of
    that arch."""
    return jax.jit(jsteps.make_train_step(jconfigs.get_reduced(arch),
                                          JAdamWConfig()))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _lr(k):
    """The default schedule's lr at step k (warmup over 100 steps)."""
    return 3e-4 * (k + 1) / 100


def _port_params(arch, jparams):
    tcfg = tconfigs.get_reduced(arch)
    return params_from_numpy(tcfg, numpy_tree(jparams)).trainable()


def _assert_params_close(model, jparams, tol):
    want = dict(params_from_numpy(model.cfg, numpy_tree(jparams))
                .named_parameters())
    worst = max(float((p.detach() - want[k]).abs().max())
                for k, p in model.named_parameters())
    assert worst <= tol, (worst, tol)


# zamba2's gradient norm: 1e-4.  Its gradients go through the chunked SSD,
# which the reference factors as exp(cum_t) exp(-cum_j) and the port takes
# as exp(cum_t - cum_j) (tests/test_torch_models.py holds the forward at
# the same 1e-4); the loss itself agrees at 1e-5.
GRAD_NORM_REL = {"zamba2-2.7b": 1e-4}


def _assert_metrics_close(tm, jm, arch="starcoder2-3b", first=True):
    """`first`: the step starts from equal parameters.  After it they
    differ by up to 2 sum(lr) (below), which moves the gradient norm
    (1e-4 relative from then on) far more than the loss."""
    for k in ("loss", "grad_norm", "lr", "ce"):
        rel = REL
        if k == "grad_norm":
            rel = GRAD_NORM_REL.get(arch, REL) if first else 1e-4
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rel,
                                   err_msg=k)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, n_steps):
    """tests/test_models.py::test_train_step_smoke on both packages, from
    the same parameters, for 1 and 3 steps."""
    cfg = jconfigs.get_reduced(arch)
    jparams = reference_params(arch, 0)
    model = _port_params(arch, jparams)
    jopt = jinit_opt_state(jparams, JAdamWConfig())
    topt = init_opt_state(dict(model.named_parameters()), AdamWConfig())
    jstep = _jstep(arch)
    tstep = tsteps.make_train_step(model.cfg, AdamWConfig())
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    for i in range(n_steps):
        toks = _tokens(cfg, 2, 16, seed=i)
        jparams, jopt, jm = jstep(jparams, jopt, {"tokens": jnp.asarray(toks)})
        model, topt, tm = tstep(model, topt,
                                {"tokens": torch.from_numpy(toks).long()})
        _assert_metrics_close(tm, jm, arch, first=i == 0)
        assert np.isfinite(float(tm["loss"]))
    assert int(topt["step"]) == int(jopt["step"]) == n_steps
    assert max(float((p.detach() - p0[k]).abs().max())
               for k, p in model.named_parameters()) > 0
    _assert_params_close(model, jparams,
                         2 * sum(_lr(k) for k in range(n_steps)) + 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_from_carried_optimizer_state(arch):
    """Two reference steps, then the reference's parameters, moments and
    step count carried into the port (`opt_state_from_numpy`): step 3 on
    both from the same state agrees as a first step does."""
    cfg = jconfigs.get_reduced(arch)
    jparams = reference_params(arch, 1)
    jopt = jinit_opt_state(jparams, JAdamWConfig())
    jstep = _jstep(arch)
    for i in range(2):
        jparams, jopt, _ = jstep(jparams, jopt, {"tokens": jnp.asarray(
            _tokens(cfg, 2, 16, seed=10 + i))})
    model = _port_params(arch, jparams)
    topt = opt_state_from_numpy(model, numpy_tree(jopt), AdamWConfig())
    assert int(topt["step"]) == 2
    for k, m in topt["m"].items():
        assert m.dtype == torch.float32 and m.shape == model.get_parameter(k).shape
    toks = _tokens(cfg, 2, 16, seed=12)
    jparams, jopt, jm = jstep(jparams, jopt, {"tokens": jnp.asarray(toks)})
    model, topt, tm = tsteps.make_train_step(model.cfg, AdamWConfig())(
        model, topt, {"tokens": torch.from_numpy(toks).long()})
    _assert_metrics_close(tm, jm, arch)
    _assert_params_close(model, jparams, 2 * _lr(2) + 1e-6)


def test_deepseek_bf16_moments_and_remat_match_reference():
    """Reduced deepseek-v3-671b as its published config trains it: bf16
    AdamW moments and remat "full" (the reference's `jax.checkpoint` with
    no policy), two steps on both packages from the same parameters, the
    MTP loss included.  Both round the moments to bf16 after each step; a
    moment on the other side of a bf16 rounding boundary moves the next
    update by at most 2^-8 of a step, inside the 2 sum(lr) + 1e-6 the
    parameters are held to.  Loss, grad norm, lr, ce and the MTP
    cross-entropy as the rules above."""
    arch = "deepseek-v3-671b"
    jcfg = jconfigs.get_reduced(arch).replace(moments_dtype="bfloat16",
                                              remat=True)
    jparams = reference_params(arch, 4)
    model = _port_params(arch, jparams)
    tcfg = model.cfg.replace(moments_dtype="bfloat16", remat=True)
    assert tcfg.remat_policy == jcfg.remat_policy == "full"
    jopt_cfg = JAdamWConfig(moments_dtype="bfloat16")
    topt_cfg = AdamWConfig(moments_dtype="bfloat16")
    jopt = jinit_opt_state(jparams, jopt_cfg)
    topt = init_opt_state(dict(model.named_parameters()), topt_cfg)
    assert {m.dtype for m in topt["m"].values()} == {torch.bfloat16}
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg))
    tstep = tsteps.make_train_step(tcfg, topt_cfg)
    for i in range(2):
        toks = _tokens(jcfg, 2, 16, seed=20 + i)
        jparams, jopt, jm = jstep(jparams, jopt, {"tokens": jnp.asarray(toks)})
        model, topt, tm = tstep(model, topt,
                                {"tokens": torch.from_numpy(toks).long()})
        _assert_metrics_close(tm, jm, arch, first=i == 0)
        np.testing.assert_allclose(float(tm["mtp_ce"]), float(jm["mtp_ce"]),
                                   rtol=REL)
    assert {v.dtype for v in topt["v"].values()} == {torch.bfloat16}
    _assert_params_close(model, jparams, 2 * (_lr(0) + _lr(1)) + 1e-6)


def test_accumulation_matches_single_batch():
    """tests/test_substrate.py::test_accumulation_matches_single_batch on
    reduced starcoder2 (qwen3-14b is not ported yet), on both packages,
    with the reference's own bounds, and the port's accumulated step
    against the reference's."""
    arch = "starcoder2-3b"
    cfg1 = jconfigs.get_reduced(arch).replace(accum_steps=1)
    jparams = reference_params(arch, 0)
    jopt = jinit_opt_state(jparams, JAdamWConfig())
    toks = np.random.default_rng(1).integers(0, cfg1.vocab_size, (4, 16),
                                             dtype=np.int32)
    jout, tout = {}, {}
    for accum in (1, 2):
        cfg = cfg1.replace(accum_steps=accum)
        jout[accum] = jax.jit(jsteps.make_train_step(cfg, JAdamWConfig()))(
            jparams, jopt, {"tokens": jnp.asarray(toks)})
        model = _port_params(arch, jparams)
        tcfg = model.cfg.replace(accum_steps=accum)
        tout[accum] = tsteps.make_train_step(tcfg, AdamWConfig())(
            model, init_opt_state(dict(model.named_parameters()),
                                  AdamWConfig()),
            {"tokens": torch.from_numpy(toks).long()})
    for out in (jout, tout):
        assert float(out[1][2]["loss"]) == pytest.approx(
            float(out[2][2]["loss"]), rel=1e-4)
    diff = max(float((a.detach() - b.detach()).abs().max()) for a, b in
               zip(tout[1][0].parameters(), tout[2][0].parameters()))
    assert diff < 5e-3
    _assert_metrics_close(tout[2][2], jout[2][2])
    _assert_params_close(tout[2][0], jout[2][0], 2 * _lr(0) + 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_matches_reference(arch):
    cfg = jconfigs.get_reduced(arch)
    jparams = reference_params(arch, 2)
    model = _port_params(arch, jparams)
    toks = _tokens(cfg, 3, 12, seed=5)
    jm = jax.jit(jsteps.make_eval_step(cfg))(jparams,
                                             {"tokens": jnp.asarray(toks)})
    tm = tsteps.make_eval_step(model.cfg)(
        model, {"tokens": torch.from_numpy(toks).long()})
    # deepseek-v3's MTP block adds its cross-entropy
    assert set(tm) == set(jm) == {"ce", "aux", "loss"} | (
        {"mtp_ce"} if cfg.mtp_depth else set())
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=REL,
                                   atol=1e-7, err_msg=k)
        assert tm[k].grad_fn is None


@pytest.mark.parametrize("arch", ARCHS)
def test_labels_take_precedence_over_tokens(arch):
    cfg = jconfigs.get_reduced(arch)
    jparams = reference_params(arch, 3)
    model = _port_params(arch, jparams)
    toks, labels = _tokens(cfg, 2, 10, seed=6), _tokens(cfg, 2, 10, seed=7)
    jl, _ = jax.jit(jmodel.loss_fn, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(toks),
                  "labels": jnp.asarray(labels)}, cfg)
    tl, _ = tmodel.loss_fn(model, {"tokens": torch.from_numpy(toks).long(),
                                   "labels": torch.from_numpy(labels).long()},
                           model.cfg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=REL)


@pytest.mark.parametrize("vocab", [10, 16])
def test_softmax_cross_entropy_masks_padded_columns(vocab):
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal((2, 5, 16)).astype(np.float32) * 4
    labels = rng.integers(0, vocab, (2, 5)).astype(np.int32)
    want = jlayers.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels), vocab)
    got = tlayers.softmax_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels), vocab)
    np.testing.assert_allclose(float(got), float(want), rtol=REL)
    bf = tlayers.softmax_cross_entropy(
        torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels),
        vocab)
    assert bf.dtype == torch.float32


def test_remat_gives_the_same_gradients():
    """Recomputing each layer in the backward changes no gradient."""
    cfg = tconfigs.get_reduced("zamba2-2.7b")
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=8)).long()
    grads = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = tmodel.init_params(c, 4).trainable()
        loss, _ = tmodel.loss_fn(model, {"tokens": toks}, c)
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _remat_batch(cfg):
    return {"tokens": torch.from_numpy(_tokens(cfg, 2, 16, seed=8)).long()}


def _remat_cfg(cfg, policy):
    """`policy` is "none" (no remat), "full" or "dots"."""
    if policy == "none":
        return cfg.replace(remat=False)
    return cfg.replace(remat=True, remat_policy=policy)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "zamba2-2.7b"])
def test_remat_dots_gives_the_same_gradients(arch):
    """Remat "dots" (selective checkpointing that keeps the products'
    outputs) against "full" and no remat: loss and every gradient bit for
    bit (the recompute runs the same CPU kernels on the same operands, and
    a kept product is the forward's own output).  zamba2's remat is
    nested, a checkpoint per Mamba2 layer inside its group's."""
    cfg = tconfigs.get_reduced(arch)
    model = tmodel.init_params(cfg, 4).trainable()
    out = {}
    for policy in ("none", "full", "dots"):
        loss, _ = tmodel.loss_fn(model, _remat_batch(cfg),
                                 _remat_cfg(cfg, policy))
        out[policy] = (loss.detach(), torch.autograd.grad(
            loss, list(model.parameters())))
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(out[policy][1], out["none"][1])), policy


@pytest.mark.parametrize("arch", ["starcoder2-3b", "zamba2-2.7b"])
def test_remat_dots_matches_reference(arch):
    """The port's loss and gradients under remat "dots" against `jax.grad`
    of the reference's `loss_fn` under `remat_policy="dots"`
    (`dots_with_no_batch_dims_saveable`): loss within 1e-5, each gradient
    within 1e-4 relative L2 (f32 sums in other orders)."""
    jcfg = _remat_cfg(jconfigs.get_reduced(arch), "dots")
    jparams = reference_params(arch, 0)
    toks = _tokens(jcfg, 2, 16, seed=8)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {"tokens": jnp.asarray(toks)}, jcfg),
        has_aux=True)(jparams)
    model = _port_params(arch, jparams)
    tcfg = _remat_cfg(model.cfg, "dots")
    names, leaves = zip(*model.named_parameters())
    loss, _ = tmodel.loss_fn(model, {"tokens": torch.from_numpy(toks).long()},
                             tcfg)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL)
    want = dict(params_from_numpy(tcfg, numpy_tree(jgrads))
                .named_parameters())
    for k, g in grads.items():
        diff = float(torch.linalg.vector_norm((g - want[k]).double()))
        scale = float(torch.linalg.vector_norm(want[k].double()))
        assert diff <= 1e-4 * scale or diff <= 1e-12, (k, diff, scale)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "zamba2-2.7b"])
def test_remat_dots_keeps_the_products(arch):
    """The backward's products, counted at the dispatcher with the
    recompute taken whole (no early stop).  Under "dots" the backward runs
    the aten.mm calls of the backward with no remat, none recomputed, and
    fewer than "full" by at least the forward's products inside the
    layers, by exactly these where the remat is not nested (starcoder2;
    zamba2's Mamba2 layers are recomputed twice under "full").  Batched
    products (aten.bmm: the plain attention's scores) are recomputed
    under both, as the reference's policy keeps no product with batch
    dims."""
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    cfg = tconfigs.get_reduced(arch)
    model = tmodel.init_params(cfg, 4).trainable()
    fwd, bwd = {}, {}
    for policy in ("none", "full", "dots"):
        with torch_checkpoint.set_checkpoint_early_stop(False):
            with _CountOps() as f:
                loss, _ = tmodel.loss_fn(model, _remat_batch(cfg),
                                         _remat_cfg(cfg, policy))
            with _CountOps() as b:
                torch.autograd.grad(loss, list(model.parameters()))
        fwd[policy], bwd[policy] = f.ops, b.ops
    with _CountOps() as head:
        tlayers.logits_from_hidden(model, torch.zeros(2, 16, cfg.d_model),
                                   cfg)
    in_layers = fwd["none"][mm] - head.ops[mm]
    assert fwd["dots"][mm] == fwd["full"][mm] == fwd["none"][mm]
    assert in_layers > 0
    assert bwd["dots"][mm] == bwd["none"][mm]
    fewer = bwd["full"][mm] - bwd["dots"][mm]
    assert fewer == in_layers if arch == "starcoder2-3b" else fewer > in_layers
    assert bwd["dots"][bmm] == bwd["full"][bmm] > bwd["none"][bmm]


def _attention_function_on_the_cpu(monkeypatch, calls):
    """Route `ops.flash_attention` through `FlashAttention` on CPU tensors,
    its two kernels replaced by their plain versions.  The forward writes
    its output and log-sum-exp as a ctypes launch does: into buffers from
    `torch.empty`, through numpy, where the dispatcher does not see it.
    `calls` counts each."""
    from repro_torch.kernels import flash_attention as fa_kernel

    def fwd(q, k, v, *, causal=True, return_lse=False):
        assert return_lse and not torch.is_grad_enabled()
        calls["fwd"] += 1
        b, sq, h, _ = q.shape
        out = torch.empty((b, sq, h, v.shape[3]), dtype=q.dtype)
        lse = torch.empty((b, h, sq), dtype=torch.float32)
        o, l = tref.attention_lse(q, k, v, causal=causal)
        out.numpy()[...] = o.numpy()
        lse.numpy()[...] = l.numpy()
        return out, lse

    def bwd(q, k, v, out, lse, dout, *, causal=True):
        calls["bwd"] += 1
        return tref.attention_bwd(q, k, v, out, lse, dout, causal=causal)

    monkeypatch.setattr(fa_kernel, "flash_attention", fwd)
    monkeypatch.setattr(fa_kernel, "flash_attention_bwd", bwd)
    monkeypatch.setattr(
        tops, "flash_attention",
        lambda q, k, v, *, causal=True:
        fa_kernel.FlashAttention.apply(q, k, v, causal))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_reruns_the_attention_kernel(monkeypatch, policy):
    """A reduced starcoder2 step whose attention goes through the autograd
    Function the card uses (`FlashAttention`), its kernels' plain versions
    writing behind the dispatcher's back as the CUDA kernels do.  Under
    either remat policy the recompute reruns the forward kernel (2 per
    layer a step, 1 backward), as `torch.empty` is never a kept output;
    the gradients equal autograd of the plain forward within 1e-4
    relative L2 (the blocked backward sums in another order), and "dots"
    equals "full" bit for bit."""
    cfg = _remat_cfg(tconfigs.get_reduced("starcoder2-3b"), policy)
    model = tmodel.init_params(cfg, 5).trainable()
    batch = _remat_batch(cfg)

    def grads(c):
        loss, _ = tmodel.loss_fn(model, batch, c)
        return torch.autograd.grad(loss, list(model.parameters()))

    want = grads(cfg)
    calls = {"fwd": 0, "bwd": 0}
    _attention_function_on_the_cpu(monkeypatch, calls)
    got = grads(cfg)
    assert calls == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}
    for g, w in zip(got, want):
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + 1e-12
    if policy == "dots":
        full = grads(_remat_cfg(cfg, "full"))
        assert all(torch.equal(a, b) for a, b in zip(got, full))


def test_only_the_train_model_requires_grad():
    cfg = tconfigs.get_reduced("starcoder2-3b")
    model = tmodel.init_params(cfg, 0)
    assert not any(p.requires_grad for p in model.parameters())
    assert model.trainable() is model
    assert all(p.requires_grad for p in model.parameters())


def _ssd_args(requires_grad):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 2, 4, generator=g, requires_grad=requires_grad)
    return (x, torch.rand(1, 8, 2), -torch.ones(2), torch.randn(1, 8, 4),
            torch.randn(1, 8, 4), torch.ones(2))


def _wkv_args(requires_grad):
    g = torch.Generator().manual_seed(0)
    r = torch.randn(1, 8, 2, 4, generator=g, requires_grad=requires_grad)
    return (r, torch.randn(1, 8, 2, 4), torch.randn(1, 8, 2, 4),
            torch.rand(1, 8, 2, 4), torch.randn(2, 4))


@pytest.mark.parametrize("fn,args", [(ssd_kernel.mamba2_ssd, _ssd_args),
                                     (wkv_kernel.rwkv6_wkv, _wkv_args)])
def test_kernels_without_backward_refuse_a_gradient(fn, args):
    """The raw SSD and WKV wrappers return outputs with no grad_fn: asked
    to record a gradient they raise instead, naming where the gradient
    goes (each one's autograd Function).  Without a gradient they go on
    to their usual operand checks (these CPU tensors are refused
    there)."""
    route = "Mamba2SSD" if fn is ssd_kernel.mamba2_ssd else "RWKV6WKV"
    with pytest.raises(NotImplementedError, match=route):
        fn(*args(True))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*args(True))
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args(False))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b"])
def test_scan_models_train_on_the_cpu(arch):
    """zamba2 and rwkv6 train through the plain SSD and WKV on the CPU."""
    out = ttrain.train(arch, steps=2, batch=2, seq=16, log_every=100)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def _ssd_function_on_the_cpu(monkeypatch, calls):
    """Route `ops.mamba2_ssd` through `Mamba2SSD` on CPU tensors, its two
    kernels replaced by their plain versions: the forward at the kernel's
    64-step chunk (no chunk states: the plain backward recomputes them),
    the backward `ref.mamba2_ssd_bwd`.  `calls` counts each."""
    def fwd(x, dt, a, b, c, d, state=None, *, chunk=128,
            return_states=False):
        assert return_states and not torch.is_grad_enabled()
        calls["fwd"] += 1
        y, final = tref.mamba2_ssd(x, dt, a, b, c, d, state,
                                   chunk=tref.SSD_BWD_CHUNK)
        return y, final, torch.empty(0)

    def bwd(x, dt, a, b, c, d, state, dy, dstate_out, *, states):
        calls["bwd"] += 1
        calls["dstate_out"].append(dstate_out)
        return tref.mamba2_ssd_bwd(x, dt, a, b, c, d, state, dy,
                                   dstate_out)

    monkeypatch.setattr(ssd_kernel, "mamba2_ssd", fwd)
    monkeypatch.setattr(ssd_kernel, "mamba2_ssd_bwd", bwd)
    monkeypatch.setattr(
        tops, "mamba2_ssd",
        lambda x, dt, a, b, c, d, state=None, *, chunk=128:
        ssd_kernel.Mamba2SSD.apply(x, dt, a, b, c, d, state))


@pytest.mark.parametrize("dtype,remat", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", True)])
def test_zamba2_step_through_the_ssd_function(monkeypatch, dtype, remat):
    """A reduced zamba2 step whose SSD goes through the autograd Function
    the card uses (`Mamba2SSD`), with the kernels' plain versions in their
    place, against autograd of the plain forward from the same weights:
    the Function saves what its backward takes (across remat's
    recompute), passes None for the final state's unused gradient,
    returns each gradient in its operand's type, and reaches a_log,
    dt_bias and d_skip.  Each tensor's gradient within 1e-4 of the other
    in relative L2 in f32 (two chunkings of the same f32 sums); in bf16
    within 2e-2 (each path rounds its bf16 gradients in other places)."""
    cfg = tconfigs.get_reduced("zamba2-2.7b").replace(dtype=dtype,
                                                      remat=remat)
    model = tmodel.init_params(cfg, 3).trainable()
    named = dict(model.named_parameters())
    toks = torch.from_numpy(_tokens(cfg, 2, 40, seed=12)).long()

    def grads():
        loss, _ = tmodel.loss_fn(model, {"tokens": toks}, cfg)
        return (float(loss.detach()),
                torch.autograd.grad(loss, list(named.values())))

    want_loss, want = grads()
    calls = {"fwd": 0, "bwd": 0, "dstate_out": []}
    _ssd_function_on_the_cpu(monkeypatch, calls)
    got_loss, got = grads()
    # remat is nested, as in the reference (repro/models/model.py:155-158
    # checkpoints the group's body and, inside it, each Mamba2 layer's):
    # a layer's forward runs in the forward, in its group's recompute and
    # in its own recompute
    assert calls["fwd"] == cfg.n_layers * (3 if remat else 1)
    assert calls["bwd"] == cfg.n_layers
    assert calls["dstate_out"] == [None] * cfg.n_layers
    rel = 1e-4 if dtype == "float32" else 2e-2
    assert got_loss == pytest.approx(want_loss, rel=rel)
    for name, g, w in zip(named, got, want):
        assert g.dtype == w.dtype == named[name].dtype, name
        gap = float((g.double() - w.double()).norm() / w.double().norm())
        assert gap <= rel, (name, gap)
    for leaf in ("a_log", "dt_bias", "d_skip"):
        hits = [k for k in named if k.endswith(leaf)]
        assert len(hits) == cfg.n_layers, leaf
        for k in hits:
            assert float(got[list(named).index(k)].abs().max()) > 0, k


def _wkv_function_on_the_cpu(monkeypatch, calls):
    """Route `ops.rwkv6_wkv` through `RWKV6WKV` on CPU tensors, its two
    kernels replaced by their plain versions: the forward at the kernel's
    64-step chunk (no chunk states: the plain backward recomputes them),
    the backward `ref.rwkv6_wkv_bwd`.  `calls` counts each."""
    def fwd(r, k, v, w, u, state=None, *, chunk=64, return_states=False):
        assert return_states and not torch.is_grad_enabled()
        calls["fwd"] += 1
        assert w.dtype == torch.float32 and w.is_contiguous()
        out, final = tref.rwkv6_wkv(r, k, v, w, u, state,
                                    chunk=tref.WKV_BWD_CHUNK)
        return out, final, torch.empty(0)

    def bwd(r, k, v, w, u, state, do, dstate_out, *, states):
        calls["bwd"] += 1
        calls["dstate_out"].append(dstate_out)
        return tref.rwkv6_wkv_bwd(r, k, v, w, u, state, do, dstate_out)

    monkeypatch.setattr(wkv_kernel, "rwkv6_wkv", fwd)
    monkeypatch.setattr(wkv_kernel, "rwkv6_wkv_bwd", bwd)
    monkeypatch.setattr(
        tops, "rwkv6_wkv",
        lambda r, k, v, w, u, state=None, *, chunk=64:
        wkv_kernel.RWKV6WKV.apply(r, k, v, w, u, state))


@pytest.mark.parametrize("dtype,remat", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", True)])
def test_rwkv6_step_through_the_wkv_function(monkeypatch, dtype, remat):
    """A reduced rwkv6 step whose WKV goes through the autograd Function
    the card uses (`RWKV6WKV`), with the kernels' plain versions in their
    place, against autograd of the plain forward from the same weights:
    w reaches the kernel in f32 and contiguous, the Function saves what
    its backward takes (across remat's recompute), passes None for the
    final state's unused gradient, returns each gradient in its operand's
    type (u's in its own), and reaches the bonus u and the decay's
    parameters.  Each tensor's gradient within 1e-4 of the other in
    relative L2 in f32 (the plain backward against autograd of the
    chunked forward: the same f32 terms, summed in other orders); in bf16
    within 2e-2 (each path rounds its bf16 gradients in other places)."""
    cfg = tconfigs.get_reduced("rwkv6-3b").replace(dtype=dtype, remat=remat)
    model = tmodel.init_params(cfg, 3).trainable()
    named = dict(model.named_parameters())
    toks = torch.from_numpy(_tokens(cfg, 2, 90, seed=13)).long()

    def grads():
        loss, _ = tmodel.loss_fn(model, {"tokens": toks}, cfg)
        return (float(loss.detach()),
                torch.autograd.grad(loss, list(named.values())))

    want_loss, want = grads()
    calls = {"fwd": 0, "bwd": 0, "dstate_out": []}
    _wkv_function_on_the_cpu(monkeypatch, calls)
    got_loss, got = grads()
    # under remat a layer's forward runs in the forward and again in its
    # recompute
    assert calls["fwd"] == cfg.n_layers * (2 if remat else 1)
    assert calls["bwd"] == cfg.n_layers
    assert calls["dstate_out"] == [None] * cfg.n_layers
    rel = 1e-4 if dtype == "float32" else 2e-2
    assert got_loss == pytest.approx(want_loss, rel=rel)
    for name, g, w in zip(named, got, want):
        assert g.dtype == w.dtype == named[name].dtype, name
        gap = float((g.double() - w.double()).norm() / w.double().norm())
        assert gap <= rel, (name, gap)
    for leaf in ("bonus_u", "decay_base", "decay_w2"):
        hits = [k for k in named if k.endswith(leaf)]
        assert len(hits) == cfg.n_layers, leaf
        for k in hits:
            assert float(got[list(named).index(k)].abs().max()) > 0, k


def test_train_rejects_a_mesh():
    with pytest.raises(NotImplementedError, match="item 16"):
        ttrain.train("starcoder2-3b", steps=1, mesh_data=2)


def test_train_needs_a_card_by_default():
    from repro_torch import device
    device.set_device("cuda")
    try:
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.train("starcoder2-3b", steps=1)
    finally:
        device.set_device("cpu")


@pytest.fixture(scope="module")
def end_to_end(tmp_path_factory, on_cpu):
    """The reference's loop and the port's `train()` on reduced starcoder2:
    40 steps, batch 8, seq 64, a checkpoint every 20 steps, from the same
    parameters."""
    arch = "starcoder2-3b"
    jparams = reference_params(arch, 0)
    ref = reference_train(arch, steps=40, batch=8, seq=64, params=jparams,
                          ckpt_dir=str(tmp_path_factory.mktemp("jck")),
                          ckpt_every=20)
    mp = pytest.MonkeyPatch()
    start_port_from(mp, numpy_tree(jparams))
    ck = tmp_path_factory.mktemp("tck")
    try:
        port = ttrain.train(arch, steps=40, batch=8, seq=64,
                            ckpt_dir=str(ck), ckpt_every=20, log_every=100)
    finally:
        mp.undo()
    return ref, port, ck


def test_train_end_to_end_follows_reference(end_to_end):
    ref, port, _ = end_to_end
    assert len(port["losses"]) == len(ref["losses"]) == 40
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=2e-4)
    assert port["first_loss"] == port["losses"][0]
    assert port["last_loss"] == port["losses"][-1]
    assert len(port["step_s"]) == 40


def test_train_end_to_end_resumes(end_to_end, tmp_path):
    """Remove the final checkpoint, and the run restarts from step 19 and
    retraces steps 20..39: losses within 1e-6 relative, parameters within
    2 sum(lr) + 1e-6.  Not bit for bit: the CPU's BLAS may round a product
    differently for operands at other addresses, and AdamW turns such a
    last-bit difference in a gradient near 0 into up to 2 lr."""
    _, port, ck = end_to_end
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000019.npz",
                                                     "step_00000039.npz"]
    resume = tmp_path / "resume"
    resume.mkdir()
    (resume / "step_00000019.npz").write_bytes(
        (ck / "step_00000019.npz").read_bytes())
    out = ttrain.train("starcoder2-3b", steps=40, batch=8, seq=64,
                       ckpt_dir=str(resume), ckpt_every=20, log_every=100)
    np.testing.assert_allclose(out["losses"], port["losses"][20:],
                               rtol=1e-6)
    tol = 2 * sum(_lr(k) for k in range(20, 40)) + 1e-6
    for a, b in zip(out["params"].parameters(), port["params"].parameters()):
        assert float((a.detach() - b.detach()).abs().max()) <= tol
    assert int(out["opt_state"]["step"]) == int(port["opt_state"]["step"])


def test_train_loads_neither_jax_nor_repro(tmp_path):
    """Reduced starcoder2 `train()` with a checkpoint, and a resume from
    it, in a fresh interpreter: neither `jax` nor `repro` loads."""
    root = Path(__file__).resolve().parents[1]
    code = f"""
import sys
sys.path.insert(0, {str(root / 'src')!r})
from repro_torch import device
device.set_device("cpu")
from repro_torch.launch.train import train
a = train("starcoder2-3b", steps=4, batch=2, seq=16, ckpt_dir={str(tmp_path)!r},
          ckpt_every=2, log_every=100)
b = train("starcoder2-3b", steps=6, batch=2, seq=16, ckpt_dir={str(tmp_path)!r},
          ckpt_every=2, log_every=100)
assert len(a["losses"]) == 4 and len(b["losses"]) == 2
loaded = sorted(m for m in sys.modules if m in ("jax", "repro")
                or m.startswith("jax.") or m.startswith("repro."))
print("LOADED", loaded)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_moe_train_loads_neither_jax_nor_repro(arch):
    """Reduced dbrx-132b or deepseek-v3-671b `train()` (the MoE's dispatch
    and combine, top-2 of 4 experts; deepseek's sigmoid router, shared
    expert and MTP loss) in a fresh interpreter: finite losses, parameters
    that move, and neither `jax` nor `repro` loads."""
    root = Path(__file__).resolve().parents[1]
    code = f"""
import sys
import math
sys.path.insert(0, {str(root / 'src')!r})
from repro_torch import device
device.set_device("cpu")
from repro_torch.launch.train import train
from repro_torch.models import model
out = train({arch!r}, steps=3, batch=2, seq=16, log_every=100)
assert len(out["losses"]) == 3 and all(map(math.isfinite, out["losses"]))
start = model.init_params(out["params"].cfg, 0, "cpu")
assert any(not (a.detach() == b).all() for a, b in
           zip(out["params"].parameters(), start.parameters()))
loaded = sorted(m for m in sys.modules if m in ("jax", "repro")
                or m.startswith("jax.") or m.startswith("repro."))
print("LOADED", loaded)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]


def test_example_trains_on_the_cpu(tmp_path):
    """examples/train_lm_torch.py, the twin of examples/train_lm.py, a few
    steps on the CPU with a checkpoint."""
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "examples/train_lm_torch.py", "--device", "cpu",
         "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
         str(tmp_path)], cwd=root, capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "loss:" in proc.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001.npz"]


def test_reference_train_fails_on_this_jax():
    """Pins the fault that makes the reference's own
    `test_train_loss_decreases_end_to_end` fail on this tree: its
    `train()` raises a sharding type error in its mesh path before the
    first step, so the twins above drive `torch_train_util.
    reference_train` instead (ROADMAP.md Queue 3)."""
    from repro.launch import train as jtrain
    with pytest.raises(Exception, match="incompatible shardings"):
        jtrain.train("starcoder2-3b", reduced=True, steps=1, batch=2,
                     seq=8, log_every=100)
