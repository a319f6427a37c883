"""Carry a reference parameter tree across to the port.

`params_from_numpy(cfg, tree)` takes the reference's parameter tree as
numpy arrays (`jax.tree.map(np.asarray, repro.models.model.init_params(
cfg, key))`) and returns the port's `LM` with those weights.  The
reference stacks its scanned layers (`[n_layers, ...]`, and `[n_groups,
shared_attn_every, ...]` for zamba2); the port's parameter names carry
those axes as module indices, so `groups.1.mamba.4.mamba.w_in` is
`tree["groups"]["mamba"]["mamba"]["w_in"][1, 4]`.  It raises on a tree leaf
it does not use (whole, every stacked index), on a parameter it cannot
find, and on a shape that differs.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Set, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, ...]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: Dict, device=None) -> LM:
    model = LM(cfg, device)
    used: Dict[Tuple[str, ...], Set[Tuple[int, ...]]] = {}
    for name, param in model.named_parameters():
        parts = name.split(".")
        keys = tuple(p for p in parts if not p.isdigit())
        idx = tuple(int(p) for p in parts if p.isdigit())
        node = tree
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                raise KeyError(f"parameter {name}: the tree has no leaf "
                               f"{'/'.join(keys)}")
            node = node[k]
        arr = np.asarray(node)
        if arr.ndim < len(idx) or arr.shape[len(idx):] != tuple(param.shape):
            raise ValueError(f"parameter {name} {tuple(param.shape)}: leaf "
                             f"{'/'.join(keys)} has shape {arr.shape}")
        leaf = np.array(arr[idx], np.float32)       # bf16 -> f32 is exact
        param.copy_(torch.from_numpy(leaf))
        used.setdefault(keys, set()).add(idx)
    for keys in _leaves(tree):
        arr = np.asarray(_get(tree, keys))
        n_idx = len(next(iter(used[keys]))) if keys in used else 0
        if (keys not in used
                or len(used[keys]) != math.prod(arr.shape[:n_idx])):
            raise ValueError(f"leaf {'/'.join(keys)} {arr.shape} is not "
                             f"(wholly) used by the {cfg.name} model")
    return model


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree
