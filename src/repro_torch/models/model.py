"""Model composition: segments of homogeneous layers
(`repro/models/model.py`).

Every architecture the port runs is a list of `Segment`s, each a stack of
identical layers run in a Python loop (the reference's `jax.lax.scan`).
The zamba2 hybrid is a stack of *groups*: N Mamba2 layers and then the one
weight-shared attention block (`LM.shared_attn`, a single module, so the
sharing is structural).  The parameter names follow the reference's tree,
with the stacked layer axes as module indices: `groups.g.mamba.i.mamba.w_in`
is the reference's `groups/mamba/mamba/w_in[g, i]`.  MoE archs are a
`dense` segment of their first `first_k_dense` layers (SwiGLU of width
`dense_d_ff`) and a `moe` segment of the rest; deepseek-v3's
multi-token-prediction block is `LM.mtp` (`proj`, `norm` and one dense
`layer`), which only the loss runs.

Caches are nested dicts of stacked tensors with the reference's shapes and
dtypes, written in place by prefill and decode.

The input is token ids (`batch["tokens"]`, through the embedding table)
or, for the archs with `input_mode="embeddings"` (phi-3-vision-4.2b,
musicgen-large, whose vision and audio frontends are stubs), the
frontend's embeddings `[B, S, D]` (`batch["embeddings"]`, cast to the
activation dtype) with the labels beside them; the embedding table stays
in the tree either way, as in the reference.

Every layer returns an aux loss beside its output (the MoE's load-balance
loss, None elsewhere); the forward returns their sum.  Training
(`loss_fn`) recomputes each layer in the backward when the config asks
for remat (`torch.utils.checkpoint`, non-reentrant): everything under the
"full" policy, as the reference's `jax.checkpoint` with no policy does;
everything but the outputs of products without batch dims under "dots",
as its `dots_with_no_batch_dims_saveable` does.
"""
from __future__ import annotations

import dataclasses
import functools
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
from repro_torch.models.layers import (MLP, ParamModule, dense,
                                       embed_tokens, logits_from_hidden,
                                       mlp_apply, rms_norm,
                                       softmax_cross_entropy)
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.rwkv import (RWKV6Layer, rwkv6_apply,
                                     rwkv6_cache_shapes)
from repro_torch.models.ssm import Mamba2, mamba2_apply, mamba2_cache_shapes

Cache = Dict[str, Any]

MOE_AUX_COEF = 0.01
MTP_LOSS_COEF = 0.3


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    n_layers: int
    kind: str                 # attn_mlp | attn_moe | mamba2 | rwkv6 | zamba_group
    cfg: ModelConfig


def model_segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.block_kind == "rwkv6":
        return [Segment("layers", cfg.n_layers, "rwkv6", cfg)]
    if cfg.block_kind == "mamba2":
        if cfg.shared_attn_every:
            if cfg.n_layers % cfg.shared_attn_every:
                raise ValueError(f"{cfg.n_layers} layers do not group by "
                                 f"{cfg.shared_attn_every}")
            return [Segment("groups", cfg.n_layers // cfg.shared_attn_every,
                            "zamba_group", cfg)]
        return [Segment("layers", cfg.n_layers, "mamba2", cfg)]
    if cfg.n_experts:
        segs = []
        if cfg.first_k_dense:
            segs.append(Segment("dense", cfg.first_k_dense, "attn_mlp",
                                _dense_cfg(cfg)))
        segs.append(Segment("moe", cfg.n_layers - cfg.first_k_dense,
                            "attn_moe", cfg))
        return segs
    return [Segment("layers", cfg.n_layers, "attn_mlp", cfg)]


def _dense_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of an MoE arch's dense layers (the leading ones and the
    MTP block's)."""
    return cfg.replace(n_experts=0, d_ff=cfg.dense_d_ff or cfg.d_ff)


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


class AttnMoELayer(ParamModule):
    def __init__(self, cfg, dtype, device):
        super().__init__(dtype, device)
        d = cfg.d_model
        self.add("norm1", (d,), "ones")
        self.attn = attention_module(cfg, dtype, device)
        self.add("norm2", (d,), "ones")
        self.moe = MoE(cfg, dtype, device)


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


_LAYERS = {"attn_mlp": AttnMLPLayer, "attn_moe": AttnMoELayer,
           "mamba2": Mamba2Layer, "rwkv6": RWKV6Layer,
           "zamba_group": ZambaGroup}


def _layer_cache_shapes(kind: str, cfg: ModelConfig, batch: int,
                        max_len: int):
    if kind in ("attn_mlp", "attn_moe"):
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
    """-> (x, cache or None, aux loss or None)."""
    if kind in ("attn_mlp", "attn_moe"):
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        attn_out, new_c = attention_apply(lp.attn, h, cfg,
                                          positions=positions, cache=cache,
                                          decode_pos=decode_pos)
        x = x + attn_out
        h = rms_norm(x, lp.norm2, cfg.norm_eps)
        if kind == "attn_moe":
            mo, aux = moe_apply(lp.moe, h, cfg)
            return x + mo, new_c, aux
        return x + mlp_apply(lp.mlp, h, cfg), new_c, None
    if kind == "mamba2":
        h = rms_norm(x, lp.norm, cfg.norm_eps)
        out, new_c = mamba2_apply(lp.mamba, h, cfg, cache=cache,
                                  decode=decode_pos is not None)
        return x + out, new_c, None
    if kind == "rwkv6":
        x, new_c = rwkv6_apply(lp, x, cfg, cache=cache,
                               decode=decode_pos is not None)
        return x, new_c, None
    if kind == "zamba_group":
        x, _, _ = _run_stack(
            "mamba2", lp.mamba, x, cfg, positions=positions,
            caches=None if cache is None else cache["mamba"],
            decode_pos=decode_pos)
        x, _, _ = _layer_apply(
            "attn_mlp", shared, x, cfg, positions=positions,
            cache=None if cache is None else cache["shared_attn"],
            decode_pos=decode_pos)
        return x, cache, None
    raise ValueError(kind)


# The products without batch dims, every overload (mm.dtype is the MoE's
# product with an f32 result): a [..., D] @ [D, F] is one of these after
# matmul folds its leading dims (the projections, the MLPs, the head).
# Batched products (aten.bmm: the plain attention's scores, the MoE's
# grouped experts) are recomputed, as the reference's policy does.
_SAVEABLE_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for remat "dots": keep the outputs
    of products without batch dims, recompute everything else.  The
    hand-written kernels launch through ctypes into buffers from
    `torch.empty`, which is recomputed, so a recompute reruns the kernel
    into a fresh buffer and no saved output is written in place."""
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE
            if op.overloadpacket in _SAVEABLE_DOTS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXTS = {
    "full": torch_checkpoint.noop_context_fn,
    "dots": functools.partial(
        torch_checkpoint.create_selective_checkpoint_contexts, _dots_policy),
}


def _remat(cfg: ModelConfig, caches, decode_pos):
    """The checkpoint's context function where each layer is recomputed in
    the backward (the config asks for it, the pass is a training forward,
    with no cache and no decode position, and a graph is being recorded),
    else None."""
    if not (cfg.remat and caches is None and decode_pos is None
            and torch.is_grad_enabled()):
        return None
    if cfg.remat_policy not in _REMAT_CONTEXTS:
        raise ValueError(f"remat_policy={cfg.remat_policy!r}: not one of "
                         f"{sorted(_REMAT_CONTEXTS)}")
    return _REMAT_CONTEXTS[cfg.remat_policy]


def _run_stack(kind: str, stack: nn.ModuleList, x, cfg, *, positions,
               caches, decode_pos, shared=None):
    """Run a stack of identical layers; `caches` is stacked or None.
    -> (x, caches, the layers' summed aux loss or None)."""
    context_fn = _remat(cfg, caches, decode_pos)
    aux = None
    for i, lp in enumerate(stack):
        if context_fn is not None:
            x, a = torch_checkpoint.checkpoint(
                _train_layer, kind, lp, x, cfg, positions, shared,
                use_reentrant=False, context_fn=context_fn)
        else:
            x, _, a = _layer_apply(kind, lp, x, cfg, positions=positions,
                                   cache=_index(caches, i),
                                   decode_pos=decode_pos, shared=shared)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, caches, aux


def _train_layer(kind, lp, x, cfg, positions, shared):
    x, _, aux = _layer_apply(kind, lp, x, cfg, positions=positions,
                             cache=None, decode_pos=None, shared=shared)
    return x, aux


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
        if cfg.mtp_depth:
            self.mtp = MTP(cfg, dtype, dev)

    def trainable(self) -> "LM":
        """Turn on `requires_grad` for every parameter (the train entry's
        model); serving's models stay without it."""
        self.requires_grad_(True)
        return self


class MTP(ParamModule):
    """deepseek-v3's multi-token-prediction block (one extra depth)."""

    def __init__(self, cfg, dtype, device):
        super().__init__(dtype, device)
        d = cfg.d_model
        self.add("proj", (2 * d, d))
        self.add("norm", (d,), "ones")
        self.layer = AttnMLPLayer(_dense_cfg(cfg), dtype, device)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """The model with every parameter drawn by the reference's init rules
    from a `torch.Generator` seeded with `seed`, on `device` (the port's
    selected device by default)."""
    return layers.init_params(LM(cfg, device), seed)


def count_params(cfg: ModelConfig) -> int:
    return sum(p.numel() for p in LM(cfg, "meta").parameters())


def count_active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token: routed experts scaled by top_k/E,
    input embedding excluded (a lookup, not a matmul).  As the reference,
    the rule goes by the names along the path of each stacked leaf (every
    leaf of the `moe` segment but its router and shared expert is
    scaled), and its integer division takes the whole stacked leaf."""
    leaves: Dict[Tuple[str, ...], int] = {}
    for name, p in LM(cfg, "meta").named_parameters():
        keys = tuple(k for k in name.split(".") if not k.isdigit())
        leaves[keys] = leaves.get(keys, 0) + p.numel()
    total = 0
    for keys, n in leaves.items():
        if "embedding" in keys and not cfg.tie_embeddings:
            continue
        if "moe" in keys and "shared" not in keys and "router" not in keys:
            n = n * cfg.moe_top_k // max(cfg.n_experts, 1)
        total += n
    return total


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
def _inputs_to_hidden(params: LM, batch: Dict[str, torch.Tensor],
                      cfg: ModelConfig) -> torch.Tensor:
    """The first layer's input [B, S, D]: the frontend's embeddings in the
    activation dtype, or the token ids' rows of the embedding table."""
    if cfg.input_mode == "embeddings":
        return batch["embeddings"].to(cfg.activation_dtype)
    return embed_tokens(params, batch["tokens"], cfg)


def forward(params: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, cache: Optional[Cache] = None, decode_pos: Optional[int] = None,
            last_only: bool = False,
            last_index: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """-> (logits [B,S,Vpad] f32, cache, aux_loss).  `cache` is written in
    place.  last_only=True computes the LM head on the final position
    only; last_index [B] selects a per-row position instead (bucketed
    prefill)."""
    x = _inputs_to_hidden(params, batch, cfg)
    b, s = x.shape[:2]
    if decode_pos is not None:
        positions = torch.full((b, s), decode_pos, dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    shared = getattr(params, "shared_attn", None)
    aux = torch.zeros((), device=x.device)
    for seg in model_segments(cfg):
        x, _, a = _run_stack(
            seg.kind, getattr(params, seg.name), x, seg.cfg,
            positions=positions,
            caches=None if cache is None else cache[seg.name],
            decode_pos=decode_pos, shared=shared)
        if a is not None:
            aux = aux + a
    if last_index is not None:
        x = x[torch.arange(b, device=x.device), last_index.long()][:, None]
    elif last_only:
        x = x[:, -1:]
    logits = logits_from_hidden(params, x, cfg)
    return logits, cache, aux


def loss_fn(params: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, metrics): next-token CE over the batch (labels, or the
    tokens themselves), plus MOE_AUX_COEF x the MoE aux loss (0 without
    experts), plus MTP_LOSS_COEF x the MTP block's CE where the config has
    one (`mtp_ce`)."""
    logits, _, aux = forward(params, batch, cfg)
    labels = batch.get("labels", batch.get("tokens"))
    ce = softmax_cross_entropy(logits[:, :-1], labels[:, 1:], cfg.vocab_size)
    loss = ce + MOE_AUX_COEF * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_depth:
        mtp_ce = _mtp_loss(params, batch, cfg)
        loss = loss + MTP_LOSS_COEF * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def _mtp_loss(params: LM, batch, cfg: ModelConfig) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction, one extra depth (predict t + 2)
    as the reference computes it: h'_t = proj([norm(emb_t); emb(token_{t+1})])
    for t < S - 1 through the dense `mtp.layer`, then the shared head."""
    mtp = params.mtp
    x = _inputs_to_hidden(params, batch, cfg)
    b, s = x.shape[:2]
    labels = batch.get("labels", batch.get("tokens"))
    h = rms_norm(x, mtp.norm, cfg.norm_eps)
    nxt = embed_tokens(params, labels, cfg)
    hp = dense(torch.cat([h[:, :-1], nxt[:, 1:]], dim=-1), mtp.proj)
    positions = torch.arange(s - 1, dtype=torch.int32,
                             device=x.device)[None].expand(b, s - 1)
    hp, _, _ = _layer_apply("attn_mlp", mtp.layer, hp, _dense_cfg(cfg),
                            positions=positions, cache=None,
                            decode_pos=None)
    logits = logits_from_hidden(params, hp, cfg)
    return softmax_cross_entropy(logits[:, :-1], labels[:, 2:],
                                 cfg.vocab_size)


def prefill(params, batch, cfg, cache, *, last_only: bool = False):
    """Full-sequence forward that also fills the cache."""
    return forward(params, batch, cfg, cache=cache, last_only=last_only)


def decode_step(params, token_batch, cfg, cache, pos: int):
    """token_batch: {'tokens': [B,1]} (or {'embeddings': [B,1,D]}); pos:
    the position of that token."""
    logits, new_cache, _ = forward(params, token_batch, cfg, cache=cache,
                                   decode_pos=pos)
    return logits[:, -1], new_cache
