"""Helpers for the training tests of the port: the reference's training
loop without its mesh, and carrying a reference parameter tree into the
port's `train()`.

`repro.launch.train.train` fails on this tree's JAX before its first step
(a `ShardingTypeError` in its mesh path: tests/test_substrate.py::
test_train_loss_decreases_end_to_end fails so, ROADMAP.md Queue 3).  So
`reference_train` runs the loop that `train()` runs, with the reference's
own parts (`make_train_step` under `jax.jit`, the synthetic pipeline,
AdamW, `CheckpointManager` with restore of the latest) on one device,
leaving out only the mesh and the sharded `device_put`s."""
import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import make_pipeline as jmake_pipeline
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as jmodel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state


def reference_params(arch: str, seed: int = 0):
    return jmodel.init_params(jconfigs.get_reduced(arch),
                              jax.random.PRNGKey(seed))


def reference_train(arch: str, *, steps: int, batch: int, seq: int,
                    ckpt_dir: str = "", ckpt_every: int = 25, seed: int = 0,
                    params=None) -> dict:
    """`repro.launch.train.train` on one device: -> {"losses", "params",
    "opt"}; `params` replaces the seeded initialisation."""
    cfg = jconfigs.get_reduced(arch)
    opt_cfg = JAdamWConfig(moments_dtype=cfg.moments_dtype,
                           total_steps=max(steps, 2))
    pipe = jmake_pipeline("synthetic", vocab_size=cfg.vocab_size,
                          seq_len=seq, global_batch=batch, seed=seed)
    step_fn = jax.jit(jmake_train_step(cfg, opt_cfg))
    mgr = JCheckpointManager(ckpt_dir) if ckpt_dir else None
    if params is None:
        params = reference_params(arch, seed)
    opt = jinit_opt_state(params, opt_cfg)
    start = 0
    if mgr is not None:
        restored, meta = mgr.restore_latest({"params": params, "opt": opt})
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = int(meta["step"]) + 1
    losses = []
    for step in range(start, steps):
        batch_np = pipe.batch(step)
        params, opt, metrics = step_fn(
            params, opt, {k: jnp.asarray(v) for k, v in batch_np.items()})
        losses.append(float(metrics["loss"]))
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step, {"params": params, "opt": opt})
    if mgr is not None:
        mgr.save(steps - 1, {"params": params, "opt": opt})
        mgr.wait()
    return {"losses": losses, "params": params, "opt": opt}


def start_port_from(monkeypatch, tree) -> None:
    """Make the port's `train()` start from the reference parameter tree
    `tree` (numpy) instead of its own seeded initialisation."""
    from repro_torch.launch import train as ttrain
    from repro_torch.models.weights import params_from_numpy

    def init_params(cfg, seed=0, device=None):
        return params_from_numpy(cfg, tree, device)
    monkeypatch.setattr(ttrain.model_lib, "init_params", init_params)


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
