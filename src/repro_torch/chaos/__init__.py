"""Shared straggler detection (the part of `repro.chaos` the live
`Executor` uses)."""
from repro_torch.chaos.speculate import find_stragglers, straggler_cutoff
