"""`repro_torch.checkpoint`: model checkpoints (`CheckpointManager`,
`save_pytree`, `load_pytree`, `latest_step`, the npz format of
`repro/checkpoint/checkpoint.py`) and the crash-safe JSON `Journal` of
the broker service.  The journal module is stdlib-only; the checkpoint
module needs numpy and torch, which every user of the port has.
"""
from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               latest_step, load_pytree,
                                               save_pytree)
from repro_torch.checkpoint.journal import Journal

__all__ = ["CheckpointManager", "Journal", "latest_step", "load_pytree",
           "save_pytree"]
