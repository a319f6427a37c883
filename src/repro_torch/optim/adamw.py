"""AdamW (`repro/optim/adamw.py`) on dicts of tensors.

The parameters, gradients and moments are dicts keyed by parameter name
(the port's names follow the reference's tree: `layers.3.attn.w_q` is
the reference's `layers/attn/w_q[3]`).  The maths is the reference's, in
f32: the global-norm clip, bias correction, weight decay decoupled inside
`delta`, and moments stored in `moments_dtype`; the one change is a global
norm that does not overflow (`global_norm`).  It is not
`torch.optim.AdamW`, whose decay and clip differ.

The reference returns new trees; the port writes the new parameters and
moments into the tensors it was given (`copy_`), so that a step never
holds two copies of the optimizer state, and returns the same dicts.  It
updates a large tensor one slice at a time (`_SLICE`; `_HOST_SLICE` on
the CPU), so that its f32 temporaries stay bounded.
The sharding-axis helpers (`abstract_opt_state`, `opt_state_axes`) belong
to the mesh code (ROADMAP.md Queue 1 item 16b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]

# The update walks a tensor of more elements than this one slice of its
# leading dimension at a time (one row where a row is larger): 2^26
# elements, 256 MiB of f32 per temporary.  Formed whole, out of place, the
# update's f32 temporaries came to about nine copies of what it takes:
# 38 GB for dbrx-132b's [16, 6144, 10752] expert stack (4.23 GB per f32
# copy) beside its weights, gradients and moments.  In place, a slice's
# update holds at most seven (1.75 GiB).
_SLICE = 1 << 26
# On the host the slices are smaller still: 2^20 elements, 4 MiB of f32
# per temporary.  The C allocator maps a block larger than 32 MiB afresh
# for each temporary, and the kernel zero-fills each of its pages on first
# touch; blocks of 4 MiB are reused from the heap.  The same bits, in
# about half the time on an 8-core host.
_HOST_SLICE = 1 << 20


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"


def cosine_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup to `peak_lr`, then a cosine to `min_lr` at
    `total_steps`; f32, as the reference."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clip((step - cfg.warmup_steps)
                      / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Tensors, cfg: AdamWConfig) -> Dict:
    """Zero moments in `moments_dtype` beside each parameter, and the step
    count (int32, on the parameters' device)."""
    dt = getattr(torch, cfg.moments_dtype)
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tensors) -> torch.Tensor:
    """The f32 2-norm of all leaves together.

    The reference sums the f32 squares as they are, which overflows to inf
    once an element passes about 1.8e19 (its square passes f32's 3.4e38);
    the clip scale is then 0 and AdamW applies weight decay alone.  The
    reference's init gives such gradients at starcoder2-3b's published
    depth: its fan-in of a [d, heads, head_dim] projection is the head
    count, so `w_k`, with 2 kv heads, is drawn at std 0.71, the attention
    scores reach hundreds, the softmax saturates, and the gradients grow
    layer by layer towards the input (chip_smoke.py's `train` phase logs
    the norms).  The port divides every leaf by the largest |x| of the
    tree before squaring and multiplies the root back, so a finite tree
    has a finite norm; where the reference does not overflow the two agree
    to f32 rounding (tests/test_torch_optim_data.py).  It takes one leaf
    at a time, so that at most one leaf's f32 copy is alive."""
    amax = torch.stack([x.abs().max().float() for x in tree.values()]).max()
    # an all-zero tree keeps the divisor 1; an inf or NaN leaf gives inf
    # or NaN (amax itself), as in the reference
    s = torch.where(amax > 0, amax, torch.ones_like(amax))
    # x.float() is x itself for an f32 leaf, so the division makes the copy
    sq = [torch.sum((x.float() / s).square_()) for x in tree.values()]
    norm = torch.sqrt(torch.sum(torch.stack(sq))) * s
    return torch.where(torch.isfinite(amax), norm, amax)


def _slices(p: torch.Tensor) -> list:
    """Indices that cover `p` in leading-dimension slices of at most
    `_SLICE` elements (`_HOST_SLICE` where that is less and `p` is on the
    CPU; a row at least); the whole of a tensor that fits."""
    limit = (min(_SLICE, _HOST_SLICE) if p.device.type == "cpu"
             else _SLICE)
    if p.numel() <= limit:
        return [...]
    rows = max(1, limit // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state: Dict,
                 cfg: AdamWConfig) -> Tuple[Tensors, Dict, Tensors]:
    """One AdamW step -> (params, state, {"lr", "grad_norm"}).  The
    parameters and moments are updated in place; `state["step"]` is a new
    tensor."""
    step = state["step"] + 1
    lr = cosine_schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.minimum(torch.ones((), device=gnorm.device),
                          cfg.clip_norm / torch.maximum(
                              gnorm, torch.full((), 1e-12,
                                                device=gnorm.device)))
    mdt = getattr(torch, cfg.moments_dtype)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for k, p in params.items():
        # elementwise arithmetic, slice by slice: the same bits as whole
        for s in _slices(p):
            ps, m, v = p[s], state["m"][k][s], state["v"][k][s]
            g32 = grads[k][s].float() * scale
            # m32 = b1 m + (1 - b1) g32;  v32 = b2 v + (1 - b2) g32^2
            m32 = m.float() * cfg.b1
            m32.add_(g32 * (1 - cfg.b1))
            v32 = v.float() * cfg.b2
            v32.add_(torch.square(g32).mul_(1 - cfg.b2))
            # delta = mh / (sqrt(vh) + eps) + wd p, formed in mh's buffer
            mh = m32 / bc1
            vh = v32 / bc2
            mh.div_(vh.sqrt_().add_(cfg.eps))
            mh.add_(ps.float() * cfg.weight_decay)
            ps.copy_(torch.sub(ps.float(), mh.mul_(lr)).to(ps.dtype))
            m.copy_(m32.to(mdt))
            v.copy_(v32.to(mdt))
    new_state = dict(state, step=step)
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
