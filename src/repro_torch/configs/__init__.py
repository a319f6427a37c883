"""Architecture registry of the port: the reference's ten archs, each
with its published config and a reduced smoke variant.

`get(name)` / `get_reduced(name)` take the public dashed ids, as in
`repro.configs`.  `cells()` enumerates the 40 (arch x shape) dry-run
cells, flagging the long_500k skips for the full-attention archs, as the
reference's does.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import LM_SHAPES, ModelConfig, ShapeConfig

_MODULES: Dict[str, str] = {
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
}

ARCH_NAMES: Tuple[str, ...] = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED


def shapes() -> Tuple[ShapeConfig, ...]:
    return LM_SHAPES


def cells() -> List[Tuple[str, ShapeConfig, bool]]:
    """All 40 assigned (arch, shape, runnable) cells."""
    return [(arch, shp, get(arch).runnable(shp))
            for arch in ARCH_NAMES for shp in LM_SHAPES]
