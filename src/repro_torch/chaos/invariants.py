"""Conservation invariants any traced run must satisfy (`repro_torch.chaos`).

The checker consumes exactly what a run already produces — terminal
`TaskRecord`s, `AllocationRecord`s, and the tracer's event stream — and
asserts that faults *moved* work around without creating, destroying, or
double-counting it:

1.  **Terminal uniqueness** — every task reaches exactly one terminal
    state (one record, one terminal trace instant), and that state is in
    the closed set {ok, failed, timeout, quarantined}; zero tasks lost.
2.  **Billing conservation** — node-seconds billed as busy across real
    allocations equal the work accounted to attempts: completed-attempt
    init+compute (trace `task.init`/`task.run` spans on non-virtual
    tracks) plus the burned partial work of every killed / requeued /
    quarantined / hedge-cancelled attempt (`ts - since` on the
    corresponding instants).  Crashes, preemptions, corruption, and
    speculation all bill through these two channels and nowhere else.
3.  **No orphaned workers** — every execution span lies inside its
    allocation's [running, expired] window: no work on nodes that were
    never granted or already released.
4.  **Allocation closure** — every allocation record ends expired
    (nothing still held after the run).
5.  **Attempt sanity** — every terminal record claims >= 1 attempt.

`benchmarks/chaos.py` gates CI on zero violations across a whole
fault-intensity sweep; the journal-recovery invariant (zero lost tasks
across kill/recover cycles) lives with the service tests, which own a
journal directory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set

TERMINAL_STATUSES = ("ok", "failed", "timeout", "quarantined")
_BURN_INSTANTS = ("task.requeue", "task.killed", "task.quarantined",
                  "task.hedge_cancel")
_TERMINAL_INSTANTS = tuple(f"task.{s}" for s in TERMINAL_STATUSES) + \
    ("task.lost",)


@dataclasses.dataclass
class InvariantReport:
    violations: List[str]
    measures: Dict[str, float]

    @property
    def ok(self) -> bool:
        return not self.violations

    def assert_ok(self) -> None:
        if self.violations:
            raise AssertionError(
                "invariant violations:\n  " + "\n  ".join(self.violations))


class InvariantChecker:
    """Run the conservation checks over one traced run."""

    def __init__(self, tol: float = 1e-6):
        self.tol = float(tol)

    def check(self, *, records: Sequence[Any],
              allocations: Sequence[Any] = (),
              events: Iterable[Any] = (),
              expected_tasks: Optional[Iterable[str]] = None
              ) -> InvariantReport:
        v: List[str] = []
        events = list(events)

        # 1. terminal uniqueness over records
        seen: Set[str] = set()
        n_lost = 0
        by_status: Dict[str, int] = {}
        for r in records:
            if r.task_id in seen:
                v.append(f"task {r.task_id}: more than one terminal record")
            seen.add(r.task_id)
            by_status[r.status] = by_status.get(r.status, 0) + 1
            if r.status == "lost":
                n_lost += 1
            elif r.status not in TERMINAL_STATUSES:
                v.append(f"task {r.task_id}: unknown terminal status "
                         f"{r.status!r}")
            if r.status != "lost" and r.attempts < 1:
                v.append(f"task {r.task_id}: terminal with attempts="
                         f"{r.attempts}")
        if n_lost:
            v.append(f"{n_lost} task(s) lost (never served)")
        if expected_tasks is not None:
            expected = set(expected_tasks)
            if expected != seen:
                missing = sorted(expected - seen)[:5]
                extra = sorted(seen - expected)[:5]
                v.append(f"terminal set mismatch: missing {missing}, "
                         f"unexpected {extra}")

        # terminal uniqueness over the trace
        term_count: Dict[str, int] = {}
        for ts, ph, name, pid, tid, dur, args in events:
            if ph == "i" and name in _TERMINAL_INSTANTS and args:
                t = args.get("task")
                if t is not None:
                    term_count[t] = term_count.get(t, 0) + 1
        for t, n in term_count.items():
            if n != 1:
                v.append(f"task {t}: {n} terminal trace instants")

        # virtual (zero-billed) tracks, alloc lifecycle windows
        virtual_pids: Set[int] = set()
        running_t: Dict[int, float] = {}
        expired_t: Dict[int, float] = {}
        for ts, ph, name, pid, tid, dur, args in events:
            if ph == "B" and name in ("alloc.queued", "alloc.running") \
                    and args and args.get("virtual"):
                virtual_pids.add(pid)
            if ph == "B" and name == "alloc.running":
                running_t.setdefault(pid, ts)
            elif ph == "i" and name == "alloc.expired":
                expired_t[pid] = ts

        # 2. billing conservation + 3. orphaned workers
        accounted = 0.0
        for ts, ph, name, pid, tid, dur, args in events:
            if ph == "X" and name in ("task.init", "task.run") \
                    and pid not in virtual_pids and pid > 0:
                a = args or {}
                accounted += float(a.get("init", a.get("compute", dur)))
                start = running_t.get(pid)
                if start is None:
                    v.append(f"{name} span for {a.get('task')} on alloc "
                             f"{pid - 1} that never ran")
                elif ts < start - self.tol:
                    v.append(f"{name} span for {a.get('task')} starts "
                             f"{start - ts:.3f}s before alloc {pid - 1} "
                             f"was granted")
                end = expired_t.get(pid)
                if end is not None and ts + dur > end + self.tol:
                    v.append(f"{name} span for {a.get('task')} outlives "
                             f"alloc {pid - 1} by {ts + dur - end:.3f}s")
            elif ph == "i" and name in _BURN_INSTANTS and args:
                accounted += max(ts - float(args.get("since", ts)), 0.0)
        billed = sum(a.busy_t for a in allocations)
        if abs(billed - accounted) > max(self.tol,
                                         self.tol * max(billed, 1.0)):
            v.append(f"billing not conserved: allocations billed "
                     f"{billed:.6f} busy-seconds, attempts account for "
                     f"{accounted:.6f}")

        # 4. allocation closure
        for a in allocations:
            if a.state != "expired":
                v.append(f"alloc {a.alloc_id}: final state {a.state!r} "
                         f"(still held after the run)")

        measures = {
            "n_records": float(len(records)),
            "n_lost": float(n_lost),
            "n_quarantined": float(by_status.get("quarantined", 0)),
            "billed_busy_s": billed,
            "accounted_busy_s": accounted,
        }
        return InvariantReport(violations=v, measures=measures)
