"""Gradient compression with error feedback, int8 block quantisation
(`repro/optim/compression.py`), on dicts of tensors.

Each gradient leaf is quantised to int8 with one scale per block of 256
values, and the quantisation error is carried into the next step (error
feedback keeps the sum of the decompressed gradients on the sum of the
true ones).  On one card no payload crosses a network: the
quantise/dequantise pair is applied to the gradients inside the train
step when asked for, as in the reference.  `torch.round` rounds half to
even, as `jnp.round` does, so the int8 payload is the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

BLOCK = 256

CompressionState = Any


def init_compression_state(params: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clip(torch.round(blocks / torch.clamp_min(scale, 1e-12)),
                   -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


@torch.no_grad()
def compress_with_feedback(grads: Dict[str, torch.Tensor],
                           err_state: Dict[str, torch.Tensor]):
    """-> (decompressed grads, new error state).  Round-trips through
    int8."""
    new_g, new_e = {}, {}
    for k, g in grads.items():
        corrected = g.float() + err_state[k]
        q, scale = _quantize(corrected)
        deq = _dequantize(q, scale, g.shape)
        new_g[k] = deq.to(g.dtype)
        new_e[k] = corrected - deq
    return new_g, new_e
