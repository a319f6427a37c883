"""Allocation lifecycle, auto-allocation, and multi-node brokered dispatch.

The elasticity layer the paper's HyperQueue setup relies on: bulk
allocations with a full lifecycle (`Allocation`), an autoallocator that
tracks backlog *cost* in seconds of queued work (`AutoAllocator`), and a
cluster-level broker holding one scheduling policy per allocation
(`Broker`, registered as ``policy="broker"``).  The same objects drive
the deterministic `simulate_cluster` discrete-event mode and the live
`Executor` (``Executor(..., autoalloc=AutoAllocConfig(...))``) — and the
allocation-lifecycle *rules* (capped grants, walltime kills, drained-dry
termination, autoalloc ordering) live once, in
`repro_torch.cluster.stepper.LifecycleStepper`, with both drivers as thin
adapters.  `repro_torch.cluster.parity` proves it differentially.
"""
from repro_torch.cluster.allocation import (DRAINING, EXPIRED, PENDING, QUEUED,
                                      RUNNING, Allocation)
from repro_torch.cluster.autoalloc import AutoAllocConfig, AutoAllocator
from repro_torch.cluster.broker import Broker
from repro_torch.cluster.sim import ClusterResult, simulate_cluster
from repro_torch.cluster.stepper import LifecycleStepper
from repro_torch.cluster.traces import (TraceTask, bimodal_trace, bursty_trace,
                                  trace_span, with_tenants)

# the parity harness imports repro_torch.core.executor at module level (which
# imports repro_torch.cluster only lazily, inside functions) — re-export it
# lazily so this package's import graph never depends on the executor
# module and the layering cannot go circular
_PARITY_EXPORTS = ("ParityReport", "VirtualClock", "compare_results",
                   "replay_live", "run_parity")


def __getattr__(name):
    if name in _PARITY_EXPORTS:
        from repro_torch.cluster import parity
        return getattr(parity, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
