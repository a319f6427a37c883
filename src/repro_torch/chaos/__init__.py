"""Deterministic fault injection + hardened recovery (`repro_torch.chaos`).

Failure is a *testable input* here, not an accident: a seeded
`FaultPlan` declares a schedule of fault events (worker crashes,
SLURM-style allocation preemptions with a grace-period drain, slow-node
degradation, task-result corruption, transient surrogate outages,
journal torn-writes) and a `ChaosInjector` fires them at the shared
`LifecycleStepper` choke point — so `simulate_cluster` and the live
`Executor` replay observe *identical* fault sequences and the parity
harness extends to faulted runs (`run_parity(..., fault_plan=...)`
stays exact).

The recovery side is hardened in `repro_torch.core`/`repro_torch.cluster`
(`RetryPolicy` backoff + seeded jitter, poison-task quarantine,
speculative re-execution of p95 stragglers, preemption-aware drain
migration); this package supplies the plan, the injector, the shared
straggler detector, and the conservation `InvariantChecker` that any
traced run must satisfy (gated by `benchmarks/chaos.py`).
"""
from repro_torch.chaos.inject import ChaosInjector, attach_chaos
from repro_torch.chaos.invariants import InvariantChecker, InvariantReport
from repro_torch.chaos.plan import FAULT_KINDS, FaultEvent, FaultPlan
from repro_torch.chaos.speculate import find_stragglers, straggler_cutoff

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "ChaosInjector",
    "attach_chaos",
    "InvariantChecker",
    "InvariantReport",
    "find_stragglers",
    "straggler_cutoff",
]
