"""The port's model checkpoints (`repro_torch.checkpoint`) against the
reference's, on the CPU.

The reference's own checks (tests/test_substrate.py: round trip,
retention and restore) on the port; the file format across packages (a
tree saved by either loads in the other, bf16 staged as f32, the same
keys); and a reduced f32 train state saved by one package's
`CheckpointManager` restored by the other, whose continuation must match
the saving package's own (the reference's loop is `torch_train_util.
reference_train`: its `train()` fails on this JAX).  Continuations from the same state: losses and
grad norms within 1e-5 relative, parameters within 2 x (the sum of the
continued steps' lr) + 1e-6 absolute (AdamW turns a gradient near 0 into
a step of about +-lr, so a sign that differs in the last bits is worth up
to 2 lr per step).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_pytree, save_pytree)
from repro_torch.launch import train as ttrain
from repro_torch.models.weights import params_from_numpy, tree_from_named
from torch_port_util import on_cpu  # noqa: F401
from torch_train_util import numpy_tree, reference_train

pytestmark = pytest.mark.usefixtures("on_cpu")

ARCH = "starcoder2-3b"


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32),
                  "d": torch.full((2, 2), 0.5, dtype=torch.bfloat16)}}


def _jtree():
    return {"a": jnp.arange(6.0).reshape(2, 3),
            "b": {"c": jnp.ones((4,), jnp.int32),
                  "d": jnp.full((2, 2), 0.5, jnp.bfloat16)}}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_substrate.py::test_checkpoint_roundtrip on the port."""
    t = _tree()
    save_pytree(tmp_path / "x.npz", t, step=7)
    got, meta = load_pytree(tmp_path / "x.npz", t)
    assert meta["step"] == 7
    for a, b in zip(_leaves(t), _leaves(got)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_checkpoint_manager_retention_and_restore(tmp_path):
    """tests/test_substrate.py::test_checkpoint_manager_retention_and_
    restore on the port."""
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    t = _tree()
    for s in (1, 2, 3, 4):
        t = {"a": t["a"] + 1, "b": {k: v + 1 for k, v in t["b"].items()}}
        mgr.save(s, t)
    mgr.wait()
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["step_00000003.npz", "step_00000004.npz"]
    got, meta = mgr.restore_latest(t)
    assert meta["step"] == 4 and latest_step(tmp_path) == 4
    assert torch.equal(got["a"], t["a"])
    got3, meta3 = mgr.restore(3, t)
    assert meta3["step"] == 3 and torch.equal(got3["a"] + 1, t["a"])


def test_restore_latest_of_an_empty_directory(tmp_path):
    assert CheckpointManager(tmp_path / "none").restore_latest(_tree()) == (
        None, None)
    assert latest_step(tmp_path / "none") is None


def test_synchronous_save_and_extra(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1, async_save=False)
    mgr.save(0, _tree(), extra={"arch": ARCH})
    mgr.save(5, _tree())
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000005.npz"]
    _, meta = load_pytree(tmp_path / "step_00000005.npz", _tree())
    assert meta == {"step": 5, "extra": {}}


def test_publish_is_atomic(tmp_path, monkeypatch):
    """A write that fails mid-way leaves the published file as it was and
    no temporary file behind."""
    path = save_pytree(tmp_path / "x.npz", _tree(), step=1)
    before = path.read_bytes()

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        save_pytree(path, _tree(), step=2)
    assert path.read_bytes() == before
    assert [p.name for p in tmp_path.iterdir()] == ["x.npz"]


def test_missing_leaf_raises(tmp_path):
    save_pytree(tmp_path / "x.npz", {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        load_pytree(tmp_path / "x.npz", {"a": torch.zeros(2),
                                         "b": torch.zeros(1)})


def test_port_reads_reference_file(tmp_path):
    jck.save_pytree(tmp_path / "j.npz", _jtree(), step=3, extra={"x": 1})
    got, meta = load_pytree(tmp_path / "j.npz", _tree())
    assert meta == {"step": 3, "extra": {"x": 1}}
    for a, b in zip(_leaves(_tree()), _leaves(got)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_reference_reads_port_file(tmp_path):
    save_pytree(tmp_path / "t.npz", _tree(), step=4)
    got, meta = jck.load_pytree(tmp_path / "t.npz", _jtree())
    assert meta["step"] == 4
    for a, b in zip(jax.tree.leaves(_jtree()), jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_files_hold_the_same_keys_and_arrays(tmp_path):
    """A model's parameters in the reference's layout: the port's file
    (from per-layer tensors, stacked) equals the reference's array by
    array, under the same keys."""
    from repro import configs as jconfigs
    cfg = jconfigs.get_reduced("zamba2-2.7b")
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(4))
    tree = jax.tree.map(np.asarray, jparams)
    model = params_from_numpy(tconfigs.get_reduced("zamba2-2.7b"), tree)
    jck.save_pytree(tmp_path / "j.npz", {"params": jparams}, step=0)
    save_pytree(tmp_path / "t.npz",
                {"params": tree_from_named(dict(model.named_parameters()))},
                step=0)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch,dtype", [("starcoder2-3b", "bfloat16"),
                                        ("zamba2-2.7b", "float32")])
def test_train_state_round_trip_is_bit_exact(tmp_path, arch, dtype):
    """A train state (parameters in `dtype`, f32 moments, the step) after
    two steps, through `CheckpointManager` and back into fresh tensors:
    every tensor equal bit for bit (bf16 goes to disk as f32 and back)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as tmodel
    from repro_torch.optim import AdamWConfig, init_opt_state
    cfg = tconfigs.get_reduced(arch).replace(dtype=dtype)
    model = tmodel.init_params(cfg, 3).trainable()
    opt = init_opt_state(dict(model.named_parameters()), AdamWConfig())
    step = make_train_step(cfg, AdamWConfig())
    for i in range(2):
        toks = torch.from_numpy(np.random.default_rng(i).integers(
            0, cfg.vocab_size, (2, 12)))
        model, opt, _ = step(model, opt, {"tokens": toks})
    named = dict(model.named_parameters())
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, ttrain.state_tree(named, opt))
    fresh = tmodel.init_params(cfg, 9)
    fresh_named = dict(fresh.named_parameters())
    fresh_opt = init_opt_state(fresh_named, AdamWConfig())
    restored, meta = mgr.restore_latest(ttrain.state_like(named, opt))
    assert meta["step"] == 1
    ttrain.load_state(fresh_named, fresh_opt, restored)
    for k, p in named.items():
        assert fresh_named[k].dtype == p.dtype
        assert torch.equal(fresh_named[k], p.detach()), k
        for part in ("m", "v"):
            assert torch.equal(fresh_opt[part][k], opt[part][k]), (part, k)
    assert int(fresh_opt["step"]) == int(opt["step"]) == 2


# --------------------------------------------------------------------------
# train states across packages
# --------------------------------------------------------------------------
def _run_reference(ckpt_dir, steps):
    return reference_train(ARCH, steps=steps, batch=4, seq=16,
                           ckpt_dir=str(ckpt_dir), ckpt_every=3)


def _run_port(ckpt_dir, steps):
    return ttrain.train(ARCH, reduced=True, steps=steps, batch=4, seq=16,
                        ckpt_dir=str(ckpt_dir), ckpt_every=3, log_every=100)


def _lr_sum(first, last):
    """Sum of the lr of steps first..last (the default schedule warms up
    over 100 steps: lr = 3e-4 (k + 1) / 100 at step k)."""
    return sum(3e-4 * (k + 1) / 100 for k in range(first, last + 1))


def _assert_continuations_agree(want, got, first, last):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    tol = 2 * _lr_sum(first, last) + 1e-6
    ref = dict(params_from_numpy(tconfigs.get_reduced(ARCH),
                                 numpy_tree(want["params"]))
               .named_parameters())
    for k, v in got["params"].named_parameters():
        err = float((v.detach() - ref[k]).abs().max())
        assert err <= tol, (k, err, tol)
    assert int(got["opt_state"]["step"]) == int(want["opt"]["step"]) == last + 1


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    _run_reference(tmp_path / "a", 3)
    assert latest_step(tmp_path / "a") == 2
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    want = _run_reference(tmp_path / "a", 6)     # the reference continues
    got = _run_port(tmp_path / "b", 6)           # the port continues
    assert len(got["losses"]) == len(want["losses"]) == 3
    _assert_continuations_agree(want, got, 3, 5)


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    _run_port(tmp_path / "a", 3)
    assert latest_step(tmp_path / "a") == 2
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    got = _run_port(tmp_path / "a", 6)           # the port continues
    want = _run_reference(tmp_path / "b", 6)     # the reference continues
    assert len(got["losses"]) == len(want["losses"]) == 3
    _assert_continuations_agree(want, got, 3, 5)
