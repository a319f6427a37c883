"""Overhead attribution: decompose `TaskRecord.overhead` from spans.

The paper (§IV-A) defines per-task scheduling overhead as
``(end - submit) - cpu_time`` with ``cpu_time = init + compute`` — one
scalar.  This module splits that scalar into additive components using
the span trace:

  queue_wait_s — time spent queued while open real capacity existed
                 (workers were busy with other tasks);
  alloc_wait_s — time spent queued with NO open real allocation (the
                 autoalloc bootstrap / SLURM-queue share of the wait);
  dispatch_s   — dispatch decision -> occupancy (the per-task dispatch
                 latency the paper measures in milliseconds on HQ);
  retry_s      — work burned by walltime kills plus retry backoff: each
                 killed attempt's ``[dispatch mark, release]`` interval
                 (its partial init + run cannot be split from the trace
                 — the attempt never completed — so the whole interval
                 is retry; with a `RetryPolicy` the interval extends
                 through the backoff delay to the requeue release);
  quarantine_s — the final burned interval of a poison task that was
                 quarantined after killing `quarantine_after` workers
                 (earlier burned attempts are retry_s as usual);
  speculation_s— hedged-execution surcharge: for tasks that were
                 speculatively re-executed (``task.speculate`` /
                 ``task.hedge_cancel`` in the trace), the share of the
                 record's overhead not explained by the winner lineage's
                 queue/dispatch/retry components — the loser lineage's
                 cost.  Exactly zero for non-hedged tasks;
  init_s       — reported alongside, NOT summed into overhead: the
                 final attempt's server init is part of ``cpu_time`` by
                 the §IV-A definition, but it is the cost warm-start
                 scheduling exists to avoid, so the breakdown surfaces
                 it.

Additivity: ``queue_wait + alloc_wait + dispatch + retry + quarantine +
speculation`` equals the record's unclamped overhead exactly for tasks
that completed or were killed (see `tests/test_obs.py` and the hard
assert in `benchmarks/overhead_attribution.py`, which covers hedged
runs); `attribute_overhead` returns per-task
breakdowns plus aggregate totals, and the drivers surface the totals in
`Executor.metrics()["overhead_attribution"]` and
`ClusterResult.overhead_attribution`.

Multi-tenant runs additionally get ``"by_tenant"``: the same overhead
components aggregated per tenant, plus served ``cpu_s`` (init + compute
from the attempt spans) and the deadline SLO tallies
(``deadline_total`` / ``deadline_missed`` / ``deadline_miss_rate``) —
the per-tenant accounting the broker service reports.  Tasks with no
recorded tenant fall under ``"default"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

_TERMINAL = ("task.ok", "task.failed", "task.timeout", "task.killed",
             "task.lost", "task.quarantined")


@dataclasses.dataclass
class OverheadBreakdown:
    """Additive decomposition of one task's scheduling overhead."""
    task_id: str
    queue_wait_s: float = 0.0
    alloc_wait_s: float = 0.0
    dispatch_s: float = 0.0
    retry_s: float = 0.0
    quarantine_s: float = 0.0
    speculation_s: float = 0.0
    init_s: float = 0.0           # informational: final-attempt init
    status: str = ""

    @property
    def overhead_s(self) -> float:
        """The §IV-A overhead this breakdown decomposes (init excluded:
        it is cpu_time by definition)."""
        return (self.queue_wait_s + self.alloc_wait_s + self.dispatch_s
                + self.retry_s + self.quarantine_s + self.speculation_s)

    def as_dict(self) -> Dict[str, float]:
        return {"queue_wait_s": self.queue_wait_s,
                "alloc_wait_s": self.alloc_wait_s,
                "dispatch_s": self.dispatch_s,
                "retry_s": self.retry_s,
                "quarantine_s": self.quarantine_s,
                "speculation_s": self.speculation_s,
                "init_s": self.init_s,
                "overhead_s": self.overhead_s}


def _merge(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _overlap(lo: float, hi: float,
             merged: List[Tuple[float, float]]) -> float:
    total = 0.0
    for a, b in merged:
        if b <= lo:
            continue
        if a >= hi:
            break
        total += min(hi, b) - max(lo, a)
    return total


def capacity_intervals(events: Iterable) -> List[Tuple[float, float]]:
    """Merged wall-time intervals during which at least one open REAL
    allocation was running (virtual surrogate allocations are not
    capacity).  Derived from the ``alloc.running`` B/E spans; an
    unclosed B extends to the last event timestamp."""
    events = list(events)
    end_of_trace = max((e[0] for e in events), default=0.0)
    open_b: Dict[Tuple[int, int], float] = {}
    spans: List[Tuple[float, float]] = []
    for ts, ph, name, pid, tid, _dur, args in events:
        if name != "alloc.running":
            continue
        if ph == "B":
            if args and args.get("virtual"):
                continue
            open_b[(pid, tid)] = ts
        elif ph == "E":
            start = open_b.pop((pid, tid), None)
            if start is not None:
                spans.append((start, ts))
    spans.extend((start, end_of_trace) for start in open_b.values())
    return _merge(spans)


def attribute_overhead(events: Iterable) -> Dict[str, Any]:
    """Per-task `OverheadBreakdown`s + aggregate totals from a tracer's
    event list (`Tracer.events()`).  Tasks with incomplete data (events
    dropped by the ring buffer) are still reported with what survived.
    """
    events = list(events)
    capacity = capacity_intervals(events)
    tasks: Dict[str, OverheadBreakdown] = {}
    # per-tenant SLO sidecar state, keyed by task id (tenant/deadline
    # ride on the first-attempt task.queued instant; cpu and terminal
    # time come from the attempt spans)
    tenant_of: Dict[str, str] = {}
    deadline_of: Dict[str, float] = {}
    cpu_of: Dict[str, float] = {}
    end_of: Dict[str, float] = {}
    submit_of: Dict[str, float] = {}
    hedged: set = set()

    def task(args) -> Optional[OverheadBreakdown]:
        tid = args.get("task") if args else None
        if tid is None:
            return None
        bd = tasks.get(tid)
        if bd is None:
            bd = tasks[tid] = OverheadBreakdown(task_id=tid)
        return bd

    for ts, ph, name, _pid, _tid, dur, args in events:
        if name == "task.queued" and ph == "X":
            bd = task(args)
            if bd is not None:
                busy = _overlap(ts, ts + dur, capacity)
                bd.queue_wait_s += busy
                bd.alloc_wait_s += dur - busy
        elif name == "task.queued" and ph == "i" and args:
            tid = args.get("task")
            if tid is not None:
                if tid not in submit_of or ts < submit_of[tid]:
                    submit_of[tid] = ts
                if "tenant" in args:
                    tenant_of[tid] = args["tenant"]
                if "deadline" in args:
                    deadline_of[tid] = float(args["deadline"])
        elif name == "task.dispatch" and ph == "X":
            bd = task(args)
            if bd is not None:
                bd.dispatch_s += dur
        elif name == "task.init" and ph == "X":
            bd = task(args)
            if bd is not None:
                bd.init_s += dur
                tid = args.get("task")
                if tid is not None:
                    cpu_of[tid] = cpu_of.get(tid, 0.0) + \
                        float(args.get("init", dur))
        elif name == "task.run" and ph == "X" and args:
            tid = args.get("task")
            if tid is not None:
                cpu_of[tid] = cpu_of.get(tid, 0.0) + \
                    float(args.get("compute", dur))
        elif name in ("task.requeue", "task.killed") and ph == "i":
            bd = task(args)
            if bd is not None and args and "since" in args:
                # a backoff requeue is *released* later than the kill;
                # the retry interval runs to the release so it abuts the
                # next attempt's queued span (additivity)
                until = float(args.get("release", ts))
                bd.retry_s += max(until - float(args["since"]), 0.0)
        elif name == "task.quarantined" and ph == "i":
            bd = task(args)
            if bd is not None and args and "since" in args:
                bd.quarantine_s += max(ts - float(args["since"]), 0.0)
        elif name in ("task.speculate", "task.hedge_cancel") \
                and ph == "i" and args:
            tid = args.get("task")
            if tid is not None:
                hedged.add(tid)
        if name in _TERMINAL and ph == "i":
            bd = task(args)
            if bd is not None:
                bd.status = name.split(".", 1)[1]
                end_of[bd.task_id] = ts

    # hedged tasks: the loser lineage's cost never shows up as spans
    # (its queued entry is dropped at hedge_cancel), so the record's
    # overhead exceeds what the winner-lineage components explain.  The
    # remainder IS the speculation surcharge — assigned by balancing
    # against the trace-measured overhead so the decomposition stays
    # exactly additive.
    for tid in hedged:
        bd = tasks.get(tid)
        end = end_of.get(tid)
        sub = submit_of.get(tid)
        if bd is None or end is None or sub is None:
            continue
        measured = max((end - sub) - cpu_of.get(tid, 0.0), 0.0)
        accounted = (bd.queue_wait_s + bd.alloc_wait_s + bd.dispatch_s
                     + bd.retry_s + bd.quarantine_s)
        bd.speculation_s = max(measured - accounted, 0.0)

    totals = {"queue_wait_s": 0.0, "alloc_wait_s": 0.0, "dispatch_s": 0.0,
              "retry_s": 0.0, "quarantine_s": 0.0, "speculation_s": 0.0,
              "init_s": 0.0, "overhead_s": 0.0}
    by_tenant: Dict[str, Dict[str, float]] = {}
    for bd in tasks.values():
        d = bd.as_dict()
        for k in totals:
            totals[k] += d[k]
        tenant = tenant_of.get(bd.task_id, "default")
        agg = by_tenant.get(tenant)
        if agg is None:
            agg = by_tenant[tenant] = dict.fromkeys(totals, 0.0)
            agg.update(n_tasks=0.0, cpu_s=0.0, deadline_total=0.0,
                       deadline_missed=0.0, deadline_miss_rate=0.0)
        for k in totals:
            agg[k] += d[k]
        agg["n_tasks"] += 1.0
        agg["cpu_s"] += cpu_of.get(bd.task_id, 0.0)
        deadline = deadline_of.get(bd.task_id)
        if deadline is not None:
            agg["deadline_total"] += 1.0
            end = end_of.get(bd.task_id)
            # no terminal event in the trace window counts as a miss:
            # an SLO that never resolved is not an SLO that was met
            if end is None or end > deadline:
                agg["deadline_missed"] += 1.0
    for agg in by_tenant.values():
        if agg["deadline_total"]:
            agg["deadline_miss_rate"] = (agg["deadline_missed"]
                                         / agg["deadline_total"])
    return {"per_task": tasks, "totals": totals, "by_tenant": by_tenant,
            "n_tasks": len(tasks)}


def format_breakdown(result: Dict[str, Any]) -> str:
    """Human-readable aggregate table (benchmarks print this)."""
    totals = result["totals"]
    overhead = totals["overhead_s"]
    lines = [f"overhead attribution over {result['n_tasks']} tasks "
             f"(total {overhead:.3f}s):"]
    for key in ("queue_wait_s", "alloc_wait_s", "dispatch_s", "retry_s",
                "quarantine_s", "speculation_s"):
        share = totals[key] / overhead if overhead > 0 else 0.0
        lines.append(f"  {key:<13} {totals[key]:>12.3f}s  "
                     f"({share:6.1%})")
    lines.append(f"  {'init_s':<13} {totals['init_s']:>12.3f}s  "
                 f"(cpu_time by definition, not overhead)")
    return "\n".join(lines)
