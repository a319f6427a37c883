"""Allocation lifecycle: the unit of elasticity HQ manages beside SLURM.

The paper's decisive mechanism is that HyperQueue keeps *bulk allocations*
alive next to the native scheduler: a worker group is granted for a
walltime, serves many tasks with warm model servers, and dies as a unit —
taking its warm servers with it.  Before this module the repo faked that
with a single static ``allocation_s`` float on the executor; here the
allocation is a first-class object with the full lifecycle

    pending  -> queued  -> running -> draining -> expired
    (created)   (submitted, (nodes    (no new     (walltime up /
                 waiting in  granted)  tasks)      drained dry)
                 the queue)

and its queue wait drawn from the same `BackendSpec` overhead model that
calibrates the discrete-event simulator — so `simulate_cluster` and the
live `Executor` share one notion of what an allocation costs to obtain.

Allocations are clock-agnostic: every transition takes ``now`` explicitly,
so the same object works on the simulator's virtual clock and the live
executor's ``time.monotonic()`` clock.

This module owns the *states*; the rules for WHEN transitions are driven
(grant-time worker spawn under the `max_workers` cap, walltime-kill
requeue/fail, drained-dry termination, autoalloc ordering) live once in
`repro_torch.cluster.stepper.LifecycleStepper` — never call `tick`/`terminate`
from a new driving loop; adapt the stepper instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.metrics import AllocationRecord

PENDING = "pending"
QUEUED = "queued"
RUNNING = "running"
DRAINING = "draining"
EXPIRED = "expired"


class Allocation:
    """One bulk allocation: a group of `n_workers` workers granted for
    `walltime_s` seconds after a queue wait.

    `queue_wait` is fixed at submission (drawn from a `BackendSpec` by the
    caller — `AutoAllocator.submit` — or 0.0 for live pools where the
    "queue" is just thread startup).  `busy_t` accumulates worker-busy
    seconds so utilisation is computable per allocation.
    """

    def __init__(self, alloc_id: int, n_workers: int,
                 walltime_s: Optional[float] = None, *,
                 virtual: bool = False):
        self.alloc_id = alloc_id
        self.n_workers = n_workers
        self.walltime_s = (float(walltime_s) if walltime_s is not None
                           else math.inf)
        # virtual allocations model a zero-cost service (the GP-surrogate
        # path): no node-seconds are ever billed and no busy time accrues,
        # so elasticity metrics stay about REAL capacity
        self.virtual = virtual
        self.state = PENDING
        self.queue_wait = 0.0
        self.submit_t: Optional[float] = None
        self.ready_t: Optional[float] = None   # when nodes were granted
        self.end_t: Optional[float] = None     # when the group terminated
        self.busy_t = 0.0                      # summed worker-busy seconds
        # worker-second accounting across resizes: node-seconds accrued
        # before `_ws_mark` live in `_ws_accum`; after it, bill at the
        # CURRENT n_workers (so a late resize never rewrites history)
        self._ws_accum = 0.0
        self._ws_mark: Optional[float] = None  # defaults to ready_t

    # -- lifecycle ------------------------------------------------------
    def submit(self, now: float, queue_wait: float = 0.0) -> "Allocation":
        assert self.state == PENDING, self.state
        self.state = QUEUED
        self.submit_t = now
        self.queue_wait = max(float(queue_wait), 0.0)
        return self

    @property
    def grant_t(self) -> float:
        """When the scheduler will hand over the nodes (valid once queued)."""
        assert self.submit_t is not None
        return self.submit_t + self.queue_wait

    @property
    def expiry_t(self) -> float:
        """Hard walltime bound (inf for unbounded live pools)."""
        return self.grant_t + self.walltime_s

    def tick(self, now: float) -> str:
        """Advance time-driven transitions; returns the (new) state.
        Drain and early termination are *decisions* (autoallocator /
        executor), so they have their own methods — tick only handles
        what the native scheduler does on its own: granting nodes and
        enforcing walltime."""
        if self.state == QUEUED and now >= self.grant_t:
            self.state = RUNNING
            self.ready_t = self.grant_t
        if self.state in (RUNNING, DRAINING) and now >= self.expiry_t:
            self.state = EXPIRED
            self.end_t = self.expiry_t
        return self.state

    def drain(self, now: float) -> None:
        """Stop accepting new tasks; running ones finish, then the group
        is terminated early (instead of burning node-seconds to walltime)."""
        if self.state in (QUEUED, RUNNING):
            if self.state == QUEUED:           # never started: cancel
                self.state = EXPIRED
                self.end_t = now
            else:
                self.state = DRAINING

    def terminate(self, now: float) -> None:
        """Release the nodes (drained dry, or executor shutdown)."""
        if self.state != EXPIRED:
            self.state = EXPIRED
            self.end_t = min(now, self.expiry_t) if self.ready_t is not None \
                else now

    # -- views ----------------------------------------------------------
    @property
    def open(self) -> bool:
        """Accepting new tasks (routable)."""
        return self.state in (QUEUED, RUNNING)

    def budget_left(self, now: float) -> Optional[float]:
        """Seconds of walltime remaining; None when unbounded (so
        budget-aware packing degrades to plain LPT, as documented on
        `PackingPolicy`)."""
        if math.isinf(self.walltime_s):
            return None
        if self.state == PENDING:
            return self.walltime_s
        return max(self.expiry_t - now, 0.0)

    def note_busy(self, seconds: float) -> None:
        if self.virtual:
            return
        self.busy_t += max(float(seconds), 0.0)

    def resize(self, n_workers: int, now: float) -> None:
        """Change the group size mid-lifetime (manual `scale_to`, cap
        enforcement), accruing node-seconds at the OLD size up to `now`
        so billing stays time-weighted instead of final-size x lifetime."""
        if self.ready_t is not None:
            mark = self._ws_mark if self._ws_mark is not None \
                else self.ready_t
            upto = min(now, self.expiry_t)
            self._ws_accum += max(upto - mark, 0.0) * self.n_workers
            self._ws_mark = upto
        self.n_workers = max(int(n_workers), 0)

    def node_seconds(self, until: Optional[float] = None) -> float:
        """Node-seconds actually billed (0 until granted / if cancelled;
        always 0 for virtual allocations); `until` bills a still-held
        group provisionally up to the present."""
        if self.virtual:
            return 0.0
        end = self.end_t if self.end_t is not None else until
        if self.ready_t is None or end is None:
            return 0.0
        end = min(end, self.expiry_t)
        mark = self._ws_mark if self._ws_mark is not None else self.ready_t
        return self._ws_accum + self.n_workers * max(end - mark, 0.0)

    def record(self, now: Optional[float] = None) -> AllocationRecord:
        """Snapshot as an `AllocationRecord`.  A group still held has no
        `end_t`; pass `now` to bill it provisionally up to the present
        (so live-executor node-second accounting is non-zero mid-run)."""
        end = self.end_t
        if end is None and self.ready_t is not None and now is not None:
            end = min(now, self.expiry_t)
        return AllocationRecord(
            alloc_id=self.alloc_id, n_workers=self.n_workers,
            submit_t=self.submit_t if self.submit_t is not None else 0.0,
            start_t=self.ready_t if self.ready_t is not None else float("nan"),
            end_t=end if end is not None else float("nan"),
            state=self.state, queue_wait=self.queue_wait,
            busy_t=self.busy_t, node_s=self.node_seconds(until=now))

    def __repr__(self) -> str:
        return (f"Allocation(id={self.alloc_id}, n={self.n_workers}, "
                f"state={self.state}, walltime={self.walltime_s})")
