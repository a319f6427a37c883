"""`repro_torch.checkpoint`: the crash-safe JSON `Journal` of the broker
service.

The reference's package also exports the model checkpoints
(`CheckpointManager`, `save_pytree`, `load_pytree`, `latest_step` from
`repro/checkpoint/checkpoint.py`).  Those belong to training and land
with it (ROADMAP item 15); until then this package exports the journal
only, which keeps `repro_torch.service` free of them.
"""
from repro_torch.checkpoint.journal import Journal

__all__ = ["Journal"]
