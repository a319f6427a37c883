"""HQ-style auto-allocation driven by backlog *cost*, not task counts.

HyperQueue's autoalloc watches its task queue and submits/renews bulk
SLURM allocations so capacity tracks demand; the count-based grow-only
loop this replaces could neither shrink nor tell ten 1-second tasks from
ten 10-hour ones.  The `AutoAllocator` here measures backlog in *seconds
of queued work per worker* — predictor-estimated where a runtime
predictor is bound, falling back to each request's `time_request` hint,
falling back to `default_task_cost` — and applies three guards so the
allocation churn itself stays cheap:

  * hysteresis: high/low watermarks plus a minimum interval between
    scale decisions (no flapping on oscillating backlog);
  * a max-pending cap: never more than `max_pending` allocations waiting
    in the native scheduler's queue at once (HQ's backlog guard);
  * idle draining: an allocation whose workers have all been idle for
    `idle_drain_s` is drained — running tasks finish, queued work is
    migrated by the broker, and the node-seconds stop burning.

The allocator is pure decision logic over (now, broker state, busy map):
the SAME instance drives the deterministic `simulate_cluster` loop and
the live `Executor` monitor thread — no forked decision code.  Both
drivers invoke `step` through `repro_torch.cluster.stepper.LifecycleStepper`,
which fixes its place in the tick: AFTER allocation state transitions,
so scaling decisions always see post-grant capacity (the live path once
stepped it first and sized against stale capacity).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cluster.allocation import Allocation
from repro_torch.cluster.broker import Broker


@dataclasses.dataclass
class AutoAllocConfig:
    """Knobs for the allocation policy (all times in seconds)."""
    workers_per_alloc: int = 1       # worker group size per allocation
    walltime_s: float = 600.0        # requested walltime per allocation
    n_cpus: int = 1                  # per-worker cores (queue-wait model)
    backlog_high_s: float = 30.0     # submit above this backlog/worker
    backlog_low_s: float = 5.0       # drain only below this backlog/worker
    max_pending: int = 2             # allocations queued in SLURM at once
    max_allocations: int = 8         # open (queued+running) cap
    min_allocations: int = 0         # never drain below this many
    idle_drain_s: float = 10.0       # full-idle time before draining
    hysteresis_s: float = 5.0        # min gap between scale decisions
    default_task_cost: float = 1.0   # backlog cost of a hint-less task
    # watermark semantics: True compares backlog seconds PER OPEN WORKER
    # (capacity-aware, the HQ-style default); False compares the total
    # queued seconds regardless of capacity — what the executor's legacy
    # count-based `autoscale_backlog` trigger did, kept for the alias
    per_worker: bool = True
    # True makes the watermark metric the queued-task COUNT, ignoring
    # cost estimates and hints entirely — the exact legacy trigger
    # (watermarks are then in tasks, not seconds)
    count_tasks: bool = False


class AutoAllocator:
    """Submits and drains allocations on a broker from backlog cost.

    `spec` (a `BackendSpec`) supplies the queue-wait overhead model for
    submitted allocations; None means grants are immediate — the right
    default for live thread pools, where "allocation" is worker-group
    startup.  All randomness comes from the seeded generator, so a given
    (seed, event sequence) always produces the same decisions.
    """

    def __init__(self, config: Optional[AutoAllocConfig] = None, *,
                 spec=None, seed: int = 0):
        self.config = config or AutoAllocConfig()
        self.spec = spec
        self.rng = np.random.default_rng(seed)
        self.decisions: List[Dict[str, Any]] = []   # audit trail (tests/bench)
        # total-worker ceiling across open allocations; the live executor
        # sets it to its max_workers so the grow branch stops firing at
        # the cap instead of churning submit-then-cancelled grants
        self.worker_cap: Optional[int] = None
        self._last_decision_t = -math.inf
        self._idle_since: Dict[int, float] = {}     # alloc_id -> idle start

    # ------------------------------------------------------------------
    def backlog_per_worker(self, broker: Broker) -> float:
        """The watermark metric: seconds of queued work per open-worker
        (the whole backlog if no capacity is open — that is what triggers
        bootstrap); raw totals under ``per_worker=False``; queued-task
        count (hints ignored) under ``count_tasks=True``."""
        cost = (float(broker.backlog_count()) if self.config.count_tasks
                else broker.backlog_cost(default=self.config.
                                         default_task_cost))
        if not self.config.per_worker:
            return cost
        # virtual (surrogate) allocations are not real capacity: scaling
        # decisions are about node groups that cost node-seconds
        capacity = sum(a.n_workers for a in broker.allocations()
                       if a.open and not a.virtual)
        return cost / max(capacity, 1)

    def _grow_headroom(self, broker: Broker) -> int:
        """Workers a new allocation may bring up (inf-ish without a cap)."""
        if self.worker_cap is None:
            return self.config.workers_per_alloc
        planned = sum(a.n_workers for a in broker.allocations()
                      if a.open and not a.virtual)
        return min(self.config.workers_per_alloc,
                   max(self.worker_cap - planned, 0))

    def submit(self, now: float, broker: Broker,
               walltime_s: Optional[float] = None,
               n_workers: Optional[int] = None) -> Allocation:
        """Create, queue-wait-price, and register one allocation."""
        cfg = self.config
        alloc = Allocation(broker.next_alloc_id(),
                           n_workers if n_workers is not None
                           else cfg.workers_per_alloc,
                           walltime_s if walltime_s is not None
                           else cfg.walltime_s)
        wait = (self.spec.draw_queue_wait(self.rng, alloc.walltime_s,
                                          cfg.n_cpus)
                if self.spec is not None else 0.0)
        alloc.submit(now, wait)
        broker.add_allocation(alloc)
        return alloc

    # ------------------------------------------------------------------
    def step(self, now: float, broker: Broker,
             busy_workers: Optional[Dict[int, int]] = None
             ) -> List[Tuple[str, Allocation]]:
        """One decision pass; returns the actions taken as
        ``[("submit", alloc), ("drain", alloc), ...]`` (usually 0 or 1).

        `busy_workers` maps alloc_id -> number of workers currently
        running a task (used for idle-drain detection); omitted means
        "assume busy" so nothing is drained blind.
        """
        cfg = self.config
        busy = busy_workers or {}
        actions: List[Tuple[str, Allocation]] = []
        # the virtual surrogate allocation is invisible to elasticity: it
        # must neither count against max_allocations nor be idle-drained
        allocs = [a for a in broker.allocations() if not a.virtual]
        open_allocs = [a for a in allocs if a.open]
        pending = [a for a in allocs if a.state == "queued"]
        backlog_s = self.backlog_per_worker(broker)

        # -- idle bookkeeping (runs every step, decisions or not) -------
        for a in open_allocs:
            if a.state == "running" and busy.get(a.alloc_id, None) == 0 \
                    and broker.queued_on(a.alloc_id) == 0:
                self._idle_since.setdefault(a.alloc_id, now)
            else:
                self._idle_since.pop(a.alloc_id, None)

        # -- bootstrap: any work, zero capacity -> submit regardless of
        # watermark (a cold cluster must not idle a backlog forever)
        if not open_allocs and broker.backlog_cost(
                default=cfg.default_task_cost) > 0 \
                and cfg.max_allocations > 0 \
                and self._grow_headroom(broker) > 0:
            alloc = self.submit(now, broker,
                                n_workers=self._grow_headroom(broker))
            self._note(now, "submit", alloc, backlog_s)
            actions.append(("submit", alloc))
            return actions

        if now - self._last_decision_t < cfg.hysteresis_s:
            return actions

        # -- grow: backlog over the high watermark ----------------------
        if backlog_s > cfg.backlog_high_s \
                and len(pending) < cfg.max_pending \
                and len(open_allocs) < cfg.max_allocations \
                and self._grow_headroom(broker) > 0:
            alloc = self.submit(now, broker,
                                n_workers=self._grow_headroom(broker))
            self._note(now, "submit", alloc, backlog_s)
            actions.append(("submit", alloc))
            return actions

        # -- shrink: drain one fully idle allocation --------------------
        if backlog_s < cfg.backlog_low_s \
                and len(open_allocs) > cfg.min_allocations:
            for a in sorted(open_allocs, key=lambda a: a.alloc_id,
                            reverse=True):    # newest first: LIFO shrink
                idle_t = self._idle_since.get(a.alloc_id)
                if idle_t is not None and now - idle_t >= cfg.idle_drain_s:
                    broker.drain_allocation(a.alloc_id, now)
                    self._idle_since.pop(a.alloc_id, None)
                    self._note(now, "drain", a, backlog_s)
                    actions.append(("drain", a))
                    break
        return actions

    def _note(self, now: float, action: str, alloc: Allocation,
              backlog_s: float) -> None:
        self._last_decision_t = now
        self.decisions.append({"t": now, "action": action,
                               "alloc_id": alloc.alloc_id,
                               "backlog_per_worker_s": backlog_s})
