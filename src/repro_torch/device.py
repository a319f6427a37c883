"""The package-wide device setting.

Every entry point of the port (GP fit, engines, the GS2 solver) places
its tensors on `get()`.  The default is CUDA: with no card present the
entry point raises instead of carrying on on the CPU.  Callers that want
the CPU (the test suite, a laptop run) say so with `set_device("cpu")`.
"""
from __future__ import annotations

from typing import Union

import torch

_DEVICE = torch.device("cuda")


def set_device(dev: Union[str, torch.device]) -> None:
    """Select the device every entry point of the port runs on."""
    global _DEVICE
    _DEVICE = torch.device(dev)


def get() -> torch.device:
    """The selected device; raises when it is CUDA and no card exists."""
    if _DEVICE.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; call repro_torch.device.set_device('cpu') to run "
            "on the CPU")
    return _DEVICE
