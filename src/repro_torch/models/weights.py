"""Carry parameter and optimizer trees between the port and the
reference's layout.

`params_from_numpy(cfg, tree)` takes the reference's parameter tree as
numpy arrays (`jax.tree.map(np.asarray, repro.models.model.init_params(
cfg, key))`) and returns the port's `LM` with those weights;
`opt_state_from_numpy(model, opt_tree, opt_cfg)` does the same for the
reference's AdamW state (m, v and the step count).  The reference stacks
its scanned layers (`[n_layers, ...]`, and `[n_groups, shared_attn_every,
...]` for zamba2); the port's parameter names carry those axes as module
indices, so `groups.1.mamba.4.mamba.w_in` is
`tree["groups"]["mamba"]["mamba"]["w_in"][1, 4]`.  Loading raises on a
tree leaf it does not use (whole, every stacked index), on a parameter it
cannot find, and on a shape that differs.

`tree_from_named` goes the other way, to host numpy arrays (bf16 as f32,
the checkpoint's staging), and `like_from_named` gives the same tree as
`meta` tensors of the dtypes a restore casts to: together they write and
read checkpoints in the reference's layout (`repro_torch.checkpoint`).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Set, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM

Named = Dict[str, torch.Tensor]


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, ...]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix


def _split(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """`layers.3.attn.w_q` -> (("layers", "attn", "w_q"), (3,))."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


@torch.no_grad()
def load_named(named: Named, tree: Dict, what: str = "model") -> None:
    """Copy the reference-layout `tree` (numpy arrays or tensors, stacked
    layer axes) into the port's tensors `named`, in place, with the checks
    above."""
    used: Dict[Tuple[str, ...], Set[Tuple[int, ...]]] = {}
    for name, param in named.items():
        keys, idx = _split(name)
        node = tree
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                raise KeyError(f"parameter {name}: the tree has no leaf "
                               f"{'/'.join(keys)}")
            node = node[k]
        arr = node if isinstance(node, torch.Tensor) else np.asarray(node)
        if arr.ndim < len(idx) or tuple(arr.shape[len(idx):]) != tuple(
                param.shape):
            raise ValueError(f"parameter {name} {tuple(param.shape)}: leaf "
                             f"{'/'.join(keys)} has shape {tuple(arr.shape)}")
        leaf = arr[idx] if idx else arr
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.from_numpy(np.array(leaf, np.float32))  # bf16 -> f32 is exact
        param.copy_(leaf)
        used.setdefault(keys, set()).add(idx)
    for keys in _leaves(tree):
        arr = _get(tree, keys)
        n_idx = len(next(iter(used[keys]))) if keys in used else 0
        if (keys not in used
                or len(used[keys]) != math.prod(tuple(arr.shape)[:n_idx])):
            raise ValueError(f"leaf {'/'.join(keys)} {tuple(arr.shape)} is "
                             f"not (wholly) used by the {what}")


def params_from_numpy(cfg: ModelConfig, tree: Dict, device=None) -> LM:
    model = LM(cfg, device)
    load_named(dict(model.named_parameters()), tree, f"{cfg.name} model")
    return model


def opt_state_from_numpy(model: LM, opt_tree: Dict, opt_cfg) -> Dict:
    """The reference's AdamW state (`{"m": tree, "v": tree, "step": int}`,
    numpy) as the port's (`repro_torch.optim.init_opt_state` of the
    model's parameters, moments in `opt_cfg.moments_dtype`), so that both
    packages take step k + 1 from the same state."""
    from repro_torch.optim import init_opt_state
    state = init_opt_state(dict(model.named_parameters()), opt_cfg)
    for part in ("m", "v"):
        load_named(state[part], opt_tree[part], f"{model.cfg.name} {part}")
    state["step"].fill_(int(np.asarray(opt_tree["step"])))
    return state


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _stacked(named: Named, make) -> Dict:
    """The reference's nested tree over the port's `named` tensors: each
    leaf is `make(shape, dtype, items)` with `items` the [(layer index,
    tensor)] that stack into it."""
    groups: Dict[Tuple[str, ...], list] = {}
    for name, t in named.items():
        keys, idx = _split(name)
        groups.setdefault(keys, []).append((idx, t))
    tree: Dict = {}
    for keys, items in groups.items():
        n_idx = len(items[0][0])
        lead = tuple(max(i[d] for i, _ in items) + 1 for d in range(n_idx))
        t0 = items[0][1]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = make(lead + tuple(t0.shape), t0.dtype, items)
    return tree


def tree_from_named(named: Named) -> Dict:
    """The reference-layout tree of `named` as host numpy arrays, the
    per-layer tensors stacked; bf16 is widened to f32 (exact), as the
    checkpoint stages it."""
    def make(shape, dtype, items):
        np_dtype = (np.float32 if dtype == torch.bfloat16
                    else torch.empty((), dtype=dtype).numpy().dtype)
        out = np.empty(shape, np_dtype)
        for idx, t in items:
            src = t.detach()
            out[idx] = (src.float() if dtype == torch.bfloat16
                        else src).cpu().numpy()
        return out
    return _stacked(named, make)


def like_from_named(named: Named) -> Dict:
    """The same tree as `meta` tensors in the dtypes of `named`: the
    `like` of a checkpoint restore."""
    return _stacked(named, lambda shape, dtype, items: torch.empty(
        shape, dtype=dtype, device="meta"))
