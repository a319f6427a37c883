"""Scheduling metrics from the paper (§IV-A).

The total runtime of a job (makespan) is treated as separable into two
mutually exclusive additive parts: scheduling overhead and CPU time.
Queueing time is deliberately part of the overhead (the scheduler's
responsibility is to allocate resources regardless of system utilisation).

SLR (Schedule Length Ratio, Topcuoglu et al. 2002):
    SLR = makespan / sum_i C_i
where C_i is the compute time of task i.  SLR == 1.0 is the zero-overhead
lower bound when tasks run strictly sequentially on one worker; with W
workers the work-conserving bound is max(1/W, ...) — the paper reports the
sequential-sum form, so we do too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class TaskRecord:
    """Per-task timestamps (all in seconds on one clock).

    submit_t   — when the task entered the scheduler queue
    start_t    — when its job began occupying resources (CPU timer start)
    end_t      — when it finished
    cpu_time   — CPU-occupancy time of the *job* (init + compute), per the
                 paper's definition ("the timer begins when the job starts")
    compute_t  — the application's own compute time C_i (for SLR)
    """
    task_id: str
    submit_t: float
    start_t: float
    end_t: float
    cpu_time: float
    compute_t: float
    worker: str = ""
    attempts: int = 1
    status: str = "ok"

    @property
    def overhead(self) -> float:
        """Per-task scheduling overhead = (end - submit) - cpu_time, >= 0."""
        return max((self.end_t - self.submit_t) - self.cpu_time, 0.0)


def killed_task_record(task_id: str, submit_t: float, now: float,
                       alloc_id: int, attempts: int) -> TaskRecord:
    """The canonical terminal record for a task killed at allocation
    expiry with every attempt spent: ``start_t == end_t == now`` (the
    kill instant) and zero cpu/compute time — the partial work it burned
    is billed to the allocation's ``busy_t``, never to the task.  Both
    `simulate_cluster` and the live `Executor` emit exactly this shape
    (asserted by the differential parity suite in `tests/test_parity.py`)."""
    return TaskRecord(
        task_id=task_id, submit_t=submit_t, start_t=now, end_t=now,
        cpu_time=0.0, compute_t=0.0, worker=f"alloc{alloc_id}",
        attempts=attempts, status="failed")


def quarantined_task_record(task_id: str, submit_t: float, now: float,
                            alloc_id: int, attempts: int) -> TaskRecord:
    """Terminal record for a poison task quarantined after repeatedly
    killing workers (`RetryPolicy.quarantine_after`): same canonical
    killed shape as `killed_task_record` — zero cpu/compute, the burned
    partial work billed to the allocation — but a distinct terminal
    status so quarantines are countable and never retried."""
    return TaskRecord(
        task_id=task_id, submit_t=submit_t, start_t=now, end_t=now,
        cpu_time=0.0, compute_t=0.0, worker=f"alloc{alloc_id}",
        attempts=attempts, status="quarantined")


@dataclasses.dataclass
class AllocationRecord:
    """One bulk allocation's lifetime (the `repro_torch.cluster` analogue of
    `TaskRecord`).

    start_t/end_t are NaN while the allocation never reached that point
    (e.g. cancelled while still queued); `node_seconds`/`utilization`
    treat those as zero node-seconds held.
    """
    alloc_id: int
    n_workers: int                   # group size at record time
    submit_t: float
    start_t: float                   # nodes granted (NaN if never)
    end_t: float                     # nodes released (NaN if still held)
    state: str = "expired"           # final lifecycle state
    queue_wait: float = 0.0
    busy_t: float = 0.0              # summed worker-busy seconds
    # time-weighted billed node-seconds (resize-aware); negative means
    # "not provided, derive from n_workers x held_s"
    node_s: float = -1.0

    @property
    def held_s(self) -> float:
        """Wall seconds the node group was actually held."""
        if math.isnan(self.start_t) or math.isnan(self.end_t):
            return 0.0
        return max(self.end_t - self.start_t, 0.0)

    @property
    def node_seconds(self) -> float:
        if self.node_s >= 0.0:
            return self.node_s
        return self.n_workers * self.held_s


@dataclasses.dataclass
class OffloadStats:
    """What surrogate-offload routing did to a run (`repro_torch.sched.offload`).

    n_considered        — routing decisions taken (every push);
    n_offloaded         — tasks sent down the surrogate path;
    n_surrogate_evals   — surrogate evaluations actually served;
    cpu_seconds_avoided — predicted compute seconds the offloaded tasks
                          would have burned on the real model (estimate:
                          the same cost the router gated on);
    sd_histogram        — histogram of the normalised posterior sd at
                          every variance-gated decision point
                          ({"edges": [n_bins+1], "counts": [n_bins]}) —
                          how often the surrogate was trusted, and by
                          what margin.
    """
    n_considered: int = 0
    n_offloaded: int = 0
    n_surrogate_evals: int = 0
    cpu_seconds_avoided: float = 0.0
    sd_histogram: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: {"edges": [], "counts": []})

    @property
    def offload_rate(self) -> float:
        return self.n_offloaded / self.n_considered if self.n_considered \
            else 0.0


def sd_histogram(sds: Sequence[float], n_bins: int = 10
                 ) -> Dict[str, List[float]]:
    """Fixed-width histogram of posterior-sd observations (pure python —
    runs under the dispatch lock, so no array-library round trips)."""
    if not sds:
        return {"edges": [], "counts": []}
    lo, hi = min(sds), max(sds)
    if hi <= lo:
        hi = lo + 1e-9
    width = (hi - lo) / n_bins
    counts = [0.0] * n_bins
    for s in sds:
        counts[min(int((s - lo) / width), n_bins - 1)] += 1.0
    return {"edges": [lo + i * width for i in range(n_bins + 1)],
            "counts": counts}


def node_seconds(allocs: Sequence[AllocationRecord]) -> float:
    """Total node-seconds billed across allocations: what an elastic
    policy is trying to minimise at bounded makespan cost."""
    return sum(a.node_seconds for a in allocs)


def allocation_utilization(allocs: Sequence[AllocationRecord]) -> float:
    """Busy fraction of billed node-seconds, in [0, 1]; 0 if nothing was
    ever held (so idle static pools read as the waste they are)."""
    total = node_seconds(allocs)
    if total <= 0:
        return 0.0
    return min(sum(a.busy_t for a in allocs) / total, 1.0)


@dataclasses.dataclass(frozen=True)
class BenchmarkSummary:
    name: str
    scheduler: str
    n_tasks: int
    makespan: float
    total_cpu_time: float
    total_compute: float
    scheduling_overhead: float
    slr: float
    cpu_time_stats: Dict[str, float]
    overhead_stats: Dict[str, float]


def _stats(xs: Sequence[float]) -> Dict[str, float]:
    if not xs:
        return {k: 0.0 for k in ("min", "q1", "median", "q3", "max", "mean")}
    s = sorted(xs)
    n = len(s)

    def q(p: float) -> float:
        i = p * (n - 1)
        lo, hi = int(math.floor(i)), int(math.ceil(i))
        return s[lo] + (s[hi] - s[lo]) * (i - lo)

    return {"min": s[0], "q1": q(0.25), "median": q(0.5), "q3": q(0.75),
            "max": s[-1], "mean": sum(s) / n}


def makespan(records: Sequence[TaskRecord]) -> float:
    if not records:
        return 0.0
    return max(r.end_t for r in records) - min(r.submit_t for r in records)


def total_cpu_time(records: Sequence[TaskRecord]) -> float:
    return sum(r.cpu_time for r in records)


def scheduling_overhead(records: Sequence[TaskRecord]) -> float:
    """Makespan minus the *critical-path share* of CPU time.

    The paper derives overhead by subtracting CPU time from makespan per
    job and clamping at zero (SLURM's 1 s log granularity can make it
    negative).  Aggregated the same way: sum of per-task overheads."""
    return sum(r.overhead for r in records)


def slr(records: Sequence[TaskRecord]) -> float:
    total_c = sum(r.compute_t for r in records)
    if total_c <= 0:
        return float("inf")
    return makespan(records) / total_c


def summarize(name: str, scheduler: str,
              records: Sequence[TaskRecord]) -> BenchmarkSummary:
    return BenchmarkSummary(
        name=name,
        scheduler=scheduler,
        n_tasks=len(records),
        makespan=makespan(records),
        total_cpu_time=total_cpu_time(records),
        total_compute=sum(r.compute_t for r in records),
        scheduling_overhead=scheduling_overhead(records),
        slr=slr(records),
        cpu_time_stats=_stats([r.cpu_time for r in records]),
        overhead_stats=_stats([r.overhead for r in records]),
    )


def comparison_row(a: BenchmarkSummary, b: BenchmarkSummary) -> Dict[str, float]:
    """Headline ratios used in EXPERIMENTS.md (a = baseline, b = candidate)."""
    def ratio(x, y):
        return x / y if y else float("inf")

    return {
        "makespan_reduction": 1.0 - ratio(b.makespan, a.makespan),
        "cpu_time_reduction": 1.0 - ratio(b.total_cpu_time, a.total_cpu_time),
        "overhead_ratio": ratio(a.scheduling_overhead,
                                max(b.scheduling_overhead, 1e-9)),
        "slr_a": a.slr,
        "slr_b": b.slr,
    }
