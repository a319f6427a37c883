"""End-to-end training driver (the port of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --full --steps 5 --batch 2 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
        --full --steps 5 --batch 2 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --full --steps 5 --batch 2 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch phi-3-vision-4.2b --full --steps 5 --batch 2 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-large \
        --full --steps 5 --batch 2 --seq 1024 --accum-steps 2

dbrx-132b trains on a card only cut to 1 layer (its published 40 do not
fit one card: at 1 layer its bf16 weights and gradients and f32 moments
are 53.9 GB, at 2 layers 93 GB) and at `accum_steps` 1; `chip_smoke.py`'s
`train` phase registers that cut and runs it through `train()`.
deepseek-v3-671b trains there with its MTP loss cut to 4 layers (its
first 3 dense), 32 of its 256 routed experts and `accum_steps` 1 (its
bf16 weights, gradients and bf16 moments take 44.2 GiB at that cut, 54.7
GiB with 64 experts; its 61 layers do not fit one card).

Runs the training path on one card (or on the CPU after
`repro_torch.device.set_device("cpu")`): the model initialised from a seed
with `requires_grad` on, the AdamW state, the synthetic (or memmap) data
pipeline (f32 embeddings [B, S, D] and labels for the embedding-input
archs, phi-3-vision-4.2b and musicgen-large), the eager train step (each
layer recomputed in the backward when the config asks for remat; on a
card the attention's, the Mamba2 SSD's and the RWKV6 WKV's gradients go
through their backward kernels, and the MoE's bf16 products through
`models.moe.MatmulF32`), periodic async checkpoints in the
reference's npz layout with restore of the latest, gradient accumulation
and optional int8 gradient compression.  The reference lays the model over a (data,
model) mesh; the port runs on one device, and mesh sizes other than 1
raise (ROADMAP.md Queue 1 item 16b).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import make_pipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as model_lib
from repro_torch.models.weights import (like_from_named, load_named,
                                        tree_from_named)
from repro_torch.optim import (AdamWConfig, init_compression_state,
                               init_opt_state)


def state_tree(named: Dict[str, torch.Tensor], opt_state: Dict) -> Dict:
    """The train state in the reference's checkpoint layout
    (`{"params": ..., "opt": {"m", "v", "step"[, "comp_err"]}}`, layers
    stacked), as host numpy arrays."""
    opt = {k: tree_from_named(v) for k, v in opt_state.items()
           if k != "step"}
    opt["step"] = opt_state["step"].cpu().numpy()
    return {"params": tree_from_named(named), "opt": opt}


def state_like(named: Dict[str, torch.Tensor], opt_state: Dict) -> Dict:
    """`state_tree`'s structure as `meta` tensors: a restore's `like`."""
    opt = {k: like_from_named(v) for k, v in opt_state.items()
           if k != "step"}
    opt["step"] = torch.empty((), dtype=torch.int32, device="meta")
    return {"params": like_from_named(named), "opt": opt}


def load_state(named: Dict[str, torch.Tensor], opt_state: Dict,
               tree: Dict) -> None:
    """Copy a restored `state_tree` into the model's parameters and the
    optimizer state, in place."""
    load_named(named, tree["params"], "parameters")
    for k, v in opt_state.items():
        if k == "step":
            v.copy_(torch.as_tensor(tree["opt"]["step"]))
        else:
            load_named(v, tree["opt"][k], f"optimizer {k}")


def _to_device(np_batch: Dict[str, np.ndarray], dev) -> Dict:
    return {k: torch.as_tensor(v).to(dev, torch.long
                                     if np.issubdtype(v.dtype, np.integer)
                                     else torch.float32)
            for k, v in np_batch.items()}


def train(arch: str, *, reduced: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 128, ckpt_dir: str = "",
          ckpt_every: int = 25, data_kind: str = "synthetic",
          mesh_data: int = 1, mesh_model: int = 1, seed: int = 0,
          compress_grads: bool = False, log_every: int = 10,
          accum_steps: int = 1) -> dict:
    """-> {"first_loss", "last_loss", "losses", "params"} as the
    reference returns, plus the optimizer state (`opt_state`), each
    step's gradient norm (`grad_norms`) and host seconds, ending when its
    loss is read (`step_s`)."""
    if mesh_data != 1 or mesh_model != 1:
        raise NotImplementedError(
            f"a ({mesh_data}, {mesh_model}) mesh: the port trains on one "
            f"device (ROADMAP.md Queue 1 item 16b)")
    dev = device_lib.get()
    if dev.type == "cuda":
        device_lib.strict_numerics()
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    cfg = cfg.replace(accum_steps=accum_steps)
    opt_cfg = AdamWConfig(moments_dtype=cfg.moments_dtype,
                          total_steps=max(steps, 2))

    pipe = make_pipeline(data_kind, vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=seed,
                         embeddings_dim=(cfg.d_model if cfg.input_mode ==
                                         "embeddings" else 0))
    step_fn = make_train_step(cfg, opt_cfg, compress_grads=compress_grads)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    params = model_lib.init_params(cfg, seed, dev).trainable()
    named = dict(params.named_parameters())
    opt_state = init_opt_state(named, opt_cfg)
    if compress_grads:
        opt_state["comp_err"] = init_compression_state(named)
    if mgr is not None:
        restored, meta = mgr.restore_latest(state_like(named, opt_state))
        if restored is not None:
            load_state(named, opt_state, restored)
            del restored
            start_step = int(meta["step"]) + 1
            print(f"[train] restored step {start_step - 1} from {ckpt_dir}")

    losses, grad_norms, step_s, saved = [], [], [], None
    t0 = time.time()
    for step in range(start_step, steps):
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             _to_device(pipe.batch(step), dev))
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            print(f"[train {arch}] step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({dt:.1f}s)")
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step, state_tree(named, opt_state))
            saved = step
    if mgr is not None:
        # the reference saves the last step again even where the loop just
        # saved it; the file would be the same, so the port writes it once
        if saved != steps - 1:
            mgr.save(steps - 1, state_tree(named, opt_state))
        mgr.wait()
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "losses": losses, "params": params, "opt_state": opt_state,
            "grad_norms": grad_norms, "step_s": step_s}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_NAMES))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "memmap"])
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    device_lib.set_device(args.device)
    out = train(args.arch, reduced=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, data_kind=args.data,
                mesh_data=args.mesh_data, mesh_model=args.mesh_model,
                seed=args.seed, compress_grads=args.compress_grads,
                accum_steps=args.accum_steps)
    print(f"[train] loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}")
    if device_lib.get().type == "cuda":
        print(f"[train] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


if __name__ == "__main__":
    main()
