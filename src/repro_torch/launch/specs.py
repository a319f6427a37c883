"""Abstract inputs of every (arch x shape) cell on `meta` tensors (the
port of `repro/launch/specs.py`, without the shardings, which are mesh
code: ROADMAP.md Queue 1 item 16b).

The reference builds `ShapeDtypeStruct` stand-ins; the port builds the
model, its optimizer state, its cache and the batch on the `meta` device,
with their shapes and types and no storage.  Nothing here draws a
parameter: `init_params` draws from a `torch.Generator`, which `meta`
does not have.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import model
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import AdamWConfig, init_opt_state

META = torch.device("meta")


def batch_input_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, torch.Tensor]:
    """The step's batch: token ids [B, S] (int64, as the port's data path
    gives them), or the frontend's f32 embeddings [B, S, D] with the
    labels beside them in training; S is 1 in decode."""
    b = shape.global_batch
    s = 1 if shape.mode == "decode" else shape.seq_len
    if cfg.input_mode == "embeddings":
        specs = {"embeddings": torch.empty((b, s, cfg.d_model),
                                           dtype=torch.float32, device=META)}
        if shape.mode == "train":
            specs["labels"] = torch.empty((b, s), dtype=torch.long,
                                          device=META)
        return specs
    return {"tokens": torch.empty((b, s), dtype=torch.long, device=META)}


def cell_arguments(cfg: ModelConfig, shape: ShapeConfig,
                   opt_cfg: Optional[AdamWConfig] = None) -> tuple:
    """The arguments of the cell's step (`launch/steps.py`): (model,
    optimizer state, batch) for train, (model, batch, cache) for prefill,
    (model, cache, batch, pos) for decode, with `pos` the last position of
    the cache (a host int, as the port's decode takes it)."""
    opt_cfg = opt_cfg or AdamWConfig(moments_dtype=cfg.moments_dtype)
    batch = batch_input_specs(cfg, shape)
    if shape.mode == "train":
        params = model.LM(cfg, META).trainable()
        opt = init_opt_state(dict(params.named_parameters()), opt_cfg)
        return params, opt, batch
    params = model.LM(cfg, META)
    cache = model.init_cache(cfg, shape.global_batch, shape.seq_len, META)
    if shape.mode == "prefill":
        return params, batch, cache
    return params, cache, batch, shape.seq_len - 1
