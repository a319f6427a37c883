"""Declarative, seeded fault schedules (`FaultPlan`).

A plan is data, not behaviour: a sorted tuple of `FaultEvent`s with
virtual-clock fire times.  The same plan object is handed to the sim and
to the live replay, and because every event names its victim by a
deterministic index (resolved against sorted driver state at fire time,
never by RNG at fire time), both drivers observe the same faults at the
same virtual instants — the property the faulted parity suite pins.

`FaultPlan.generate` draws a plan from per-kind Poisson rates with
`numpy.random.default_rng(seed)`, so fault *schedules* are reproducible
across hosts; everything downstream of the plan is RNG-free.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

FAULT_KINDS = (
    "worker_crash",       # kill one busy worker's process (in-flight dies)
    "preempt",            # SLURM-style preemption: grace-period drain
    "slow_node",          # degrade one node by `factor` for `duration_s`
    "corrupt_result",     # next real completion returns garbage (fatal)
    "surrogate_outage",   # surrogate backend down for `duration_s`
    "journal_torn",       # next journal publish is torn mid-write
)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``target`` is a deterministic victim *index*, resolved at fire time
    against the driver's sorted candidate list (busy workers for
    crashes, open real allocations for preemptions, running nodes for
    slowdowns) via ``target % len(candidates)`` — index resolution, not
    RNG, so sim and live pick the same victim.  ``duration_s`` is the
    preemption grace window, outage length, or slowdown length;
    ``factor`` is the slow-node compute multiplier.
    """
    t: float
    kind: str
    target: int = 0
    duration_s: float = 0.0
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {FAULT_KINDS})")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A sorted, immutable schedule of `FaultEvent`s."""
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        ordered = tuple(sorted(self.events,
                               key=lambda e: (e.t, FAULT_KINDS.index(e.kind),
                                              e.target)))
        object.__setattr__(self, "events", ordered)

    def __len__(self) -> int:
        return len(self.events)

    def kinds(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def to_dicts(self) -> List[dict]:
        return [dataclasses.asdict(e) for e in self.events]

    @staticmethod
    def from_dicts(rows: Sequence[dict]) -> "FaultPlan":
        return FaultPlan(tuple(FaultEvent(**row) for row in rows))

    @staticmethod
    def generate(seed: int = 0, horizon_s: float = 600.0,
                 rates: Optional[Dict[str, float]] = None, *,
                 grace_s: float = 60.0, slow_factor: float = 3.0,
                 slow_duration_s: float = 120.0,
                 outage_s: float = 120.0) -> "FaultPlan":
        """Draw a seeded plan: per-kind Poisson counts over the horizon,
        uniform fire times, uniform victim indices.  ``rates`` maps
        fault kind -> expected events per second (missing kinds fire
        zero events)."""
        import numpy as np
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for kind in FAULT_KINDS:                   # fixed draw order
            rate = float((rates or {}).get(kind, 0.0))
            if rate <= 0.0:
                continue
            n = int(rng.poisson(rate * horizon_s))
            for _ in range(n):
                t = float(rng.uniform(0.0, horizon_s))
                target = int(rng.integers(0, 1 << 16))
                if kind == "preempt":
                    events.append(FaultEvent(t, kind, target,
                                             duration_s=grace_s))
                elif kind == "slow_node":
                    events.append(FaultEvent(t, kind, target,
                                             duration_s=slow_duration_s,
                                             factor=slow_factor))
                elif kind == "surrogate_outage":
                    events.append(FaultEvent(t, kind, target,
                                             duration_s=outage_s))
                else:
                    events.append(FaultEvent(t, kind, target))
        return FaultPlan(tuple(events))
