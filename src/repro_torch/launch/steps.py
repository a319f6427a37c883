"""Prefill and decode step factories (`repro/launch/steps.py`, serving
part).  The reference jit-compiles these; the port runs them eagerly.
The train and eval steps wait for the training slice (ROADMAP.md Queue 1
item 15)."""
from __future__ import annotations

from repro_torch.models import model
from repro_torch.models.config import ModelConfig


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
