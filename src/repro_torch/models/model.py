"""Model composition: segments of homogeneous layers
(`repro/models/model.py`).

Every architecture the port runs is a list of `Segment`s, each a stack of
identical layers run in a Python loop (the reference's `jax.lax.scan`).
The zamba2 hybrid is a stack of *groups*: N Mamba2 layers and then the one
weight-shared attention block (`LM.shared_attn`, a single module, so the
sharing is structural).  The parameter names follow the reference's tree,
with the stacked layer axes as module indices: `groups.g.mamba.i.mamba.w_in`
is the reference's `groups/mamba/mamba/w_in[g, i]`.

Caches are nested dicts of stacked tensors with the reference's shapes and
dtypes, written in place by prefill and decode.

Training (`loss_fn`) recomputes each layer in the backward when the config
asks for remat (`torch.utils.checkpoint`, non-reentrant), as the
reference's `jax.checkpoint` with no policy does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import device as device_lib
from repro_torch.models import layers
from repro_torch.models.attention import (attention_apply,
                                          attention_cache_shapes,
                                          attention_module)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, ParamModule, embed_tokens,
                                       logits_from_hidden, mlp_apply,
                                       rms_norm, softmax_cross_entropy)
from repro_torch.models.rwkv import (RWKV6Layer, rwkv6_apply,
                                     rwkv6_cache_shapes)
from repro_torch.models.ssm import Mamba2, mamba2_apply, mamba2_cache_shapes

Cache = Dict[str, Any]

MOE_AUX_COEF = 0.01


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    n_layers: int
    kind: str                 # attn_mlp | mamba2 | rwkv6 | zamba_group
    cfg: ModelConfig


def model_segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.block_kind == "rwkv6":
        return [Segment("layers", cfg.n_layers, "rwkv6", cfg)]
    if cfg.n_experts:
        raise NotImplementedError("MoE blocks (attn_moe) are not ported yet "
                                  "(ROADMAP.md Queue 1 item 12)")
    if cfg.mtp_depth:
        raise NotImplementedError("multi-token prediction is not ported yet "
                                  "(ROADMAP.md Queue 1 item 12)")
    if cfg.input_mode != "tokens":
        raise NotImplementedError("embedding inputs are not ported yet "
                                  "(ROADMAP.md Queue 1 item 14)")
    if cfg.block_kind == "mamba2":
        if cfg.shared_attn_every:
            if cfg.n_layers % cfg.shared_attn_every:
                raise ValueError(f"{cfg.n_layers} layers do not group by "
                                 f"{cfg.shared_attn_every}")
            return [Segment("groups", cfg.n_layers // cfg.shared_attn_every,
                            "zamba_group", cfg)]
        return [Segment("layers", cfg.n_layers, "mamba2", cfg)]
    return [Segment("layers", cfg.n_layers, "attn_mlp", cfg)]


# --------------------------------------------------------------------------
# Per-layer modules / apply
# --------------------------------------------------------------------------
class AttnMLPLayer(ParamModule):
    def __init__(self, cfg, dtype, device):
        super().__init__(dtype, device)
        d = cfg.d_model
        self.add("norm1", (d,), "ones")
        self.attn = attention_module(cfg, dtype, device)
        self.add("norm2", (d,), "ones")
        self.mlp = MLP(cfg, dtype, device)


class Mamba2Layer(ParamModule):
    def __init__(self, cfg, dtype, device):
        super().__init__(dtype, device)
        self.add("norm", (cfg.d_model,), "ones")
        self.mamba = Mamba2(cfg, dtype, device)


class ZambaGroup(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.mamba = nn.ModuleList(Mamba2Layer(cfg, dtype, device)
                                   for _ in range(cfg.shared_attn_every))


_LAYERS = {"attn_mlp": AttnMLPLayer, "mamba2": Mamba2Layer,
           "rwkv6": RWKV6Layer, "zamba_group": ZambaGroup}


def _layer_cache_shapes(kind: str, cfg: ModelConfig, batch: int,
                        max_len: int):
    if kind == "attn_mlp":
        return attention_cache_shapes(cfg, batch, max_len)
    if kind == "mamba2":
        return mamba2_cache_shapes(cfg, batch)
    if kind == "rwkv6":
        return rwkv6_cache_shapes(cfg, batch)
    if kind == "zamba_group":
        n = cfg.shared_attn_every
        return {"mamba": {k: (n,) + s for k, s in
                          mamba2_cache_shapes(cfg, batch).items()},
                "shared_attn": attention_cache_shapes(cfg, batch, max_len)}
    raise ValueError(kind)


def _index(tree, i: int):
    """Layer `i` of a stacked cache tree: views, so writes land in it."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _layer_apply(kind: str, lp, x, cfg, *, positions, cache, decode_pos,
                 shared=None):
    """-> (x, cache or None)."""
    if kind == "attn_mlp":
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        attn_out, new_c = attention_apply(lp.attn, h, cfg,
                                          positions=positions, cache=cache,
                                          decode_pos=decode_pos)
        x = x + attn_out
        h = rms_norm(x, lp.norm2, cfg.norm_eps)
        return x + mlp_apply(lp.mlp, h, cfg), new_c
    if kind == "mamba2":
        h = rms_norm(x, lp.norm, cfg.norm_eps)
        out, new_c = mamba2_apply(lp.mamba, h, cfg, cache=cache,
                                  decode=decode_pos is not None)
        return x + out, new_c
    if kind == "rwkv6":
        return rwkv6_apply(lp, x, cfg, cache=cache,
                           decode=decode_pos is not None)
    if kind == "zamba_group":
        x, _ = _run_stack("mamba2", lp.mamba, x, cfg, positions=positions,
                          caches=None if cache is None else cache["mamba"],
                          decode_pos=decode_pos)
        x, _ = _layer_apply(
            "attn_mlp", shared, x, cfg, positions=positions,
            cache=None if cache is None else cache["shared_attn"],
            decode_pos=decode_pos)
        return x, cache
    raise ValueError(kind)


def _remat(cfg: ModelConfig, caches, decode_pos) -> bool:
    """Recompute each layer in the backward: the config asks for it, the
    pass is a training forward (no cache, no decode position) and a graph
    is being recorded."""
    if not (cfg.remat and caches is None and decode_pos is None
            and torch.is_grad_enabled()):
        return False
    if cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} (save the matmul outputs) "
            f"is not ported yet (ROADMAP.md Queue 1 item 23); no config "
            f"uses it")
    return True


def _run_stack(kind: str, stack: nn.ModuleList, x, cfg, *, positions,
               caches, decode_pos, shared=None):
    """Run a stack of identical layers; `caches` is stacked or None."""
    remat = _remat(cfg, caches, decode_pos)
    for i, lp in enumerate(stack):
        if remat:
            x = torch_checkpoint.checkpoint(
                _train_layer, kind, lp, x, cfg, positions, shared,
                use_reentrant=False)
            continue
        x, _ = _layer_apply(kind, lp, x, cfg, positions=positions,
                            cache=_index(caches, i), decode_pos=decode_pos,
                            shared=shared)
    return x, caches


def _train_layer(kind, lp, x, cfg, positions, shared):
    return _layer_apply(kind, lp, x, cfg, positions=positions, cache=None,
                        decode_pos=None, shared=shared)[0]


# --------------------------------------------------------------------------
# The whole model
# --------------------------------------------------------------------------
class LM(ParamModule):
    """Parameters of one architecture, named as the reference's tree.
    Built empty (`torch.empty`); `init_params` or `weights.params_from_numpy`
    fills them."""

    def __init__(self, cfg: ModelConfig, device=None):
        dev = device_lib.get() if device is None else torch.device(device)
        dtype = cfg.activation_dtype
        super().__init__(dtype, dev)
        self.cfg = cfg
        self.add("embedding", (cfg.padded_vocab, cfg.d_model), "normal")
        self.add("final_norm", (cfg.d_model,), "ones")
        if not cfg.tie_embeddings:
            self.add("lm_head", (cfg.d_model, cfg.padded_vocab))
        for seg in model_segments(cfg):
            self.add_module(seg.name, nn.ModuleList(
                _LAYERS[seg.kind](seg.cfg, dtype, dev)
                for _ in range(seg.n_layers)))
        if cfg.shared_attn_every:
            self.shared_attn = AttnMLPLayer(cfg, dtype, dev)

    def trainable(self) -> "LM":
        """Turn on `requires_grad` for every parameter (the train entry's
        model); serving's models stay without it."""
        self.requires_grad_(True)
        return self


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """The model with every parameter drawn by the reference's init rules
    from a `torch.Generator` seeded with `seed`, on `device` (the port's
    selected device by default)."""
    return layers.init_params(LM(cfg, device), seed)


def count_params(cfg: ModelConfig) -> int:
    return sum(p.numel() for p in LM(cfg, "meta").parameters())


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    return {seg.name: _stacked(seg.n_layers, _layer_cache_shapes(
        seg.kind, seg.cfg, batch, max_len)) for seg in model_segments(cfg)}


def _stacked(n: int, tree):
    if isinstance(tree, dict):
        return {k: _stacked(n, v) for k, v in tree.items()}
    return (n,) + tuple(tree)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None
               ) -> Cache:
    """Zero caches in the activation dtype, as the reference's."""
    dev = device_lib.get() if device is None else torch.device(device)

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree, dtype=cfg.activation_dtype, device=dev)

    return zeros(cache_shapes(cfg, batch, max_len))


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------
def forward(params: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, cache: Optional[Cache] = None, decode_pos: Optional[int] = None,
            last_only: bool = False,
            last_index: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """-> (logits [B,S,Vpad] f32, cache, aux_loss).  `cache` is written in
    place.  last_only=True computes the LM head on the final position
    only; last_index [B] selects a per-row position instead (bucketed
    prefill)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    b, s = x.shape[:2]
    if decode_pos is not None:
        positions = torch.full((b, s), decode_pos, dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    shared = getattr(params, "shared_attn", None)
    for seg in model_segments(cfg):
        x, _ = _run_stack(seg.kind, getattr(params, seg.name), x, seg.cfg,
                          positions=positions,
                          caches=None if cache is None else cache[seg.name],
                          decode_pos=decode_pos, shared=shared)
    if last_index is not None:
        x = x[torch.arange(b, device=x.device), last_index.long()][:, None]
    elif last_only:
        x = x[:, -1:]
    logits = logits_from_hidden(params, x, cfg)
    return logits, cache, torch.zeros((), device=x.device)


def loss_fn(params: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, metrics): next-token CE over the batch (labels, or the
    tokens themselves) plus MOE_AUX_COEF x the aux loss, which is 0 here
    (MoE is not ported; `model_segments` raises for it and for MTP)."""
    logits, _, aux = forward(params, batch, cfg)
    labels = batch.get("labels", batch.get("tokens"))
    ce = softmax_cross_entropy(logits[:, :-1], labels[:, 1:], cfg.vocab_size)
    loss = ce + MOE_AUX_COEF * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


def prefill(params, batch, cfg, cache, *, last_only: bool = False):
    """Full-sequence forward that also fills the cache."""
    return forward(params, batch, cfg, cache=cache, last_only=last_only)


def decode_step(params, token_batch, cfg, cache, pos: int):
    """token_batch: {'tokens': [B,1]}; pos: the position of that token."""
    logits, new_cache, _ = forward(params, token_batch, cfg, cache=cache,
                                   decode_pos=pos)
    return logits[:, -1], new_cache
