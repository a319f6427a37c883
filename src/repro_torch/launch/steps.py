"""Train, eval, prefill and decode step factories
(`repro/launch/steps.py`).  The reference jit-compiles these; the port
runs them eagerly.

A train step takes the model (an `LM` whose parameters require grad,
`LM.trainable()`) where the reference takes a parameter tree; it
differentiates `model.loss_fn` with `torch.autograd.grad` and updates the
parameters and moments in place (`repro_torch.optim.adamw_update`)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, adamw_update,
                               compress_with_feedback)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    *, compress_grads: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).

    Gradient accumulation: the global batch is split into cfg.accum_steps
    microbatches run one after another; gradients are summed in f32 (bf16
    when the config opts into bf16 moments), divided by the count, and the
    metrics averaged, as the reference's scan does."""
    accum = max(cfg.accum_steps, 1)
    acc_dtype = (torch.bfloat16 if cfg.moments_dtype == "bfloat16"
                 else torch.float32)

    def grads_of(params, mb):
        names, leaves = zip(*params.named_parameters())
        loss, metrics = model.loss_fn(params, mb, cfg)
        # a parameter the loss does not reach gets a zero gradient, as
        # under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(names, grads)))

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if accum == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            split = {k: v.reshape((accum, v.shape[0] // accum)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads, losses, ms = None, [], []
            for i in range(accum):
                l, m, g = grads_of(params, {k: v[i] for k, v in
                                            split.items()})
                if grads is None:
                    grads = {k: torch.zeros(x.shape, dtype=acc_dtype,
                                            device=x.device)
                             for k, x in g.items()}
                for k, x in g.items():
                    grads[k] += x.to(acc_dtype)
                losses.append(l)
                ms.append(m)
            grads = {k: g / accum for k, g in grads.items()}
            loss = sum(losses) / accum
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}
        opt = {k: v for k, v in opt_state.items() if k != "comp_err"}
        if compress_grads:
            grads, err = compress_with_feedback(grads, opt_state["comp_err"])
        params_named = dict(params.named_parameters())
        _, new_opt, om = adamw_update(params_named, grads, opt, opt_cfg)
        if compress_grads:
            new_opt["comp_err"] = err
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, new_opt, metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = model.loss_fn(params, batch, cfg)
        return metrics

    return eval_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, cache):
        logits, new_cache, _ = model.prefill(params, batch, cfg, cache,
                                             last_only=True)
        return logits[:, -1], new_cache

    return prefill_step


def make_bucketed_prefill_step(cfg: ModelConfig):
    """Prefill over a right-padded prompt bucket; the LM head runs on the
    true last token only (`last_index`, per-row).  Padding rows write
    garbage KV beyond last_index, but causal masking means nothing ever
    reads them before decode overwrites them position by position."""
    def prefill_step(params, batch, cache, last_index):
        logits, new_cache, _ = model.forward(params, batch, cfg,
                                             cache=cache,
                                             last_index=last_index)
        return logits[:, -1], new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch, pos):
        return model.decode_step(params, batch, cfg, cache, pos)

    return decode_step
