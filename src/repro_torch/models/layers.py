"""Parameter modules and elementary layers (`repro/models/layers.py`).

Parameters are declared with a `ParamDef` (shape and init rule), as in the
reference, on a `ParamModule` whose attribute names follow the reference's
parameter tree.  `init_params` fills every declared parameter from a
`torch.Generator` with the reference's rules (the numbers differ from
`jax.random`'s; the scales do not).  Norms run in f32; matmuls take the
operands' dtype and accumulate in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# --------------------------------------------------------------------------
# Parameter definitions
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "fan_in"         # fan_in | normal | zeros | ones
    scale: float = 1.0


class ParamModule(nn.Module):
    """A module whose parameters are declared with `add`.  Parameters are
    created without `requires_grad`, so serving records no graph and keeps
    no activations; the train entry turns it on for its own model
    (`model.LM.trainable`)."""

    def __init__(self, dtype: torch.dtype, device):
        super().__init__()
        self.dtype, self.device = dtype, torch.device(device)
        self.defs: Dict[str, ParamDef] = {}

    def add(self, name: str, shape: Tuple[int, ...], init: str = "fan_in",
            scale: float = 1.0) -> None:
        self.defs[name] = ParamDef(tuple(shape), init, scale)
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=self.dtype, device=self.device),
            requires_grad=False))


def _fill(p: torch.Tensor, d: ParamDef, gen: torch.Generator) -> None:
    if d.init == "zeros":
        p.zero_()
    elif d.init == "ones":
        p.fill_(1.0)
    else:
        if d.init == "fan_in":
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = d.scale / math.sqrt(max(fan_in, 1))
        else:
            std = d.scale * 0.02
        # scaled in place: an f32 draw of one expert stack is 14 GiB
        p.copy_(torch.randn(d.shape, generator=gen, device=p.device,
                            dtype=torch.float32).mul_(std))


@torch.no_grad()
def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Fill every declared parameter of `module` (in module order) from a
    generator seeded with `seed` on the parameters' device."""
    gen: Optional[torch.Generator] = None
    for mod in module.modules():
        for name, d in getattr(mod, "defs", {}).items():
            p = getattr(mod, name)
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            _fill(p, d, gen)
    return module


# --------------------------------------------------------------------------
# Elementary ops
# --------------------------------------------------------------------------
def f32(t: torch.Tensor) -> torch.Tensor:
    """`t` in f32 where the reference computes in f32; f64 stays f64, so
    that a float64 model is an oracle for the f32 one."""
    return t if t.dtype == torch.float64 else t.float()


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = f32(x)
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * f32(weight)).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., D] @ w [D, F] in x's dtype (f32 accumulation)."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class MLP(ParamModule):
    def __init__(self, cfg, dtype, device, d_model: Optional[int] = None,
                 d_ff: Optional[int] = None):
        super().__init__(dtype, device)
        d, f = d_model or cfg.d_model, d_ff or cfg.d_ff
        if cfg.mlp_kind == "swiglu":
            self.add("w_gate", (d, f))
            self.add("w_up", (d, f))
            self.add("w_down", (f, d))
        else:   # gelu two-matrix MLP (musicgen / starcoder2 style)
            self.add("w_up", (d, f))
            self.add("b_up", (f,), "zeros")
            self.add("w_down", (f, d))
            self.add("b_down", (d,), "zeros")


def mlp_apply(p: MLP, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.mlp_kind == "swiglu":
        g = dense(x, p.w_gate)
        u = dense(x, p.w_up)
        return dense(F.silu(g) * u, p.w_down)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dense(x, p.w_up, p.b_up), approximate="tanh")
    return dense(h, p.w_down, p.b_down)


# --------------------------------------------------------------------------
# Rotary position embeddings (llama split-half convention)
# --------------------------------------------------------------------------
def rope_frequencies(dim: int, theta: float, device,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=dtype,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (broadcastable)."""
    dh = x.shape[-1]
    x1, x2 = f32(x).chunk(2, dim=-1)
    freqs = rope_frequencies(dh, theta, x.device, x1.dtype)     # [Dh/2]
    angles = positions[..., None].to(x1.dtype) * freqs          # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]                         # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Embedding / logits
# --------------------------------------------------------------------------
def embed_tokens(p, tokens: torch.Tensor, cfg) -> torch.Tensor:
    return p.embedding[tokens]


def logits_from_hidden(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """-> f32 logits (f64 for a f64 model): the products of the
    activation-dtype operands are summed in f32 and kept in f32, as the
    reference's `preferred_element_type=f32`."""
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    w = p.embedding.T if cfg.tie_embeddings else p.lm_head
    return torch.matmul(f32(x), f32(w))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab_size: int) -> torch.Tensor:
    """Mean CE over tokens in f32 (f64 for f64 logits); padded vocab
    columns are masked out of the log-sum-exp at -1e30, as in the
    reference."""
    logits = f32(logits)
    if logits.shape[-1] > vocab_size:
        pad = logits.shape[-1] - vocab_size
        mask = torch.cat([
            torch.zeros(vocab_size, dtype=logits.dtype, device=logits.device),
            torch.full((pad,), -1e30, dtype=logits.dtype,
                       device=logits.device)])
        logits = logits + mask
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    return (lse - ll).mean()
