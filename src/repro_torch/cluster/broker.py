"""Multi-node brokered dispatch: one scheduling policy per allocation.

The ROADMAP's multi-node follow-on to `repro_torch.sched`: where
`WorkStealingPolicy` keeps an affinity map from model to *worker*, the
`Broker` generalises it to the cluster level — one `SchedulingPolicy`
instance per allocation (node group), a routing policy between them, and
migration of queued tasks off draining allocations.

The Broker IS a `SchedulingPolicy` (push/pop/pending/len), so it slots
into every dispatch layer unchanged: the live `Executor` uses it as its
queue (workers carry their `alloc_id` in the `WorkerView`), and the
deterministic `simulate_cluster` loop drives the same object on a
virtual clock — in both cases with allocation lifecycle transitions
applied by the shared `repro_torch.cluster.stepper.LifecycleStepper`.
Registered as ``policy="broker"`` for name-based config.

Routing, in order:
  1. model affinity — an open allocation that has run this model before
     holds warm servers for it (the cluster-level warm-start the paper's
     ~1 s per-job server init makes worth chasing);
  2. least-loaded — the open allocation with the fewest queued tasks
     per worker (O(1) by design: routing runs under the dispatch lock);
  3. nowhere — no open allocation: the task parks in an unrouted buffer
     that flushes the moment capacity appears (autoalloc bootstrap).

Pops serve the worker's own allocation queue first; an idle worker then
*steals* from the most backlogged other allocation, moving the model's
affinity with the stolen task (exactly the single-node stealing rule,
lifted one level).
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.cluster.allocation import RUNNING, Allocation
from repro_torch.sched.policy import QueueItem, SchedulingPolicy, WorkerView
from repro_torch.sched.registry import make_policy, register_policy


@register_policy("broker")
class Broker(SchedulingPolicy):
    """Cluster-level queue: allocations, per-allocation policies, routing.

    `policy` names the per-allocation scheduling policy (any registered
    name, or a zero-arg factory returning a fresh instance); every
    sub-policy shares the broker's predictor, so online cost estimates
    sharpen cluster-wide.
    """

    name = "broker"

    def __init__(self, predictor=None, policy: Any = "fcfs",
                 surrogate: Any = None):
        super().__init__(predictor)
        if isinstance(policy, SchedulingPolicy):
            raise TypeError(
                "Broker needs one policy PER allocation: pass a registered "
                "name or a zero-arg factory, not a shared instance")
        if policy == "broker":
            raise TypeError(
                "a Broker's per-allocation policy cannot itself be a "
                "broker — tasks would route into the inner broker's "
                "unrouted buffer and never pop")
        self._sub_spec = policy
        self._allocs: Dict[int, Allocation] = {}
        self._queues: Dict[int, SchedulingPolicy] = {}
        self._affinity: Dict[str, int] = {}        # model -> alloc_id
        self._unrouted: Deque[QueueItem] = deque()
        self._ids = itertools.count()
        # allocations()/_open_ids() run on EVERY routing decision, pop
        # and autoalloc probe; their sorts/filters are cached behind an
        # epoch counter bumped whenever the allocation table or any
        # open-ness-changing state transition goes through the broker
        # (the stepper reports its out-of-band `tick` transitions via
        # `invalidate_allocations`)
        self._alloc_epoch = 0
        self._sorted_cache: List[Allocation] = []
        self._sorted_epoch = -1
        self._open_cache: List[int] = []
        self._open_epoch = -1
        # incremental backlog-cost ledger: every enqueue/dequeue adjusts
        # the running total in O(1); a full rebuild happens only when the
        # predictor's version token changes
        self.default_cost = 1.0
        self._item_costs: Dict[Tuple[str, int], Tuple[float, int]] = {}
        self._cost_total = 0.0
        self._cost_version: object = None
        # surrogate-offload routing (ROADMAP follow-on): the GP surrogate
        # is modelled as a zero-queue-wait VIRTUAL allocation so the
        # drivers (simulate_cluster, live Executor) bring up its server
        # through the ordinary allocation lifecycle
        self.surrogate = None
        self._surrogate_id: Optional[int] = None
        # optional repro_torch.obs.Tracer (set via set_tracer): queue-entry,
        # steal and migration instants + allocation lifecycle spans are
        # emitted HERE, the one code path both drivers share
        self.tracer = None
        if surrogate is not None:
            self.attach_surrogate(surrogate)

    # -- construction helpers -------------------------------------------
    def _make_queue(self) -> SchedulingPolicy:
        if callable(self._sub_spec) and not isinstance(self._sub_spec, str):
            q = self._sub_spec().bind(self.predictor)
        else:
            q = make_policy(self._sub_spec, self.predictor)
        if isinstance(q, Broker):              # factories can sneak one in
            raise TypeError("per-allocation policy cannot be a broker")
        return q

    def bind(self, predictor) -> "Broker":
        super().bind(predictor)
        for q in self._queues.values():
            q.bind(self.predictor)
        return self

    def set_tracer(self, tracer) -> "Broker":
        """Attach a `repro_torch.obs.Tracer`.  Allocations registered BEFORE
        the tracer arrived (the parity harness pre-seeds the sim broker
        with the executor's initial group) retro-emit their lifecycle
        spans from their own timestamp fields, so a late-attached tracer
        produces the same allocation span sequence as an early one."""
        self.tracer = tracer
        if self.surrogate is not None:
            self.surrogate.tracer = tracer
        if tracer is not None:
            for a in self.allocations():
                tracer.alloc_state(a)
        return self

    def attach_surrogate(self, offload) -> Allocation:
        """Register a `repro_torch.sched.offload.SurrogateOffload` as a virtual
        allocation: zero queue wait (submitted at t=0, granted on the
        first tick), unbounded walltime, zero node-second billing.  Tasks
        the engine trusts are routed to its private queue; the owning
        driver spawns its (virtual) workers exactly as for any other
        allocation — no forked lifecycle code."""
        if self.surrogate is not None:
            raise ValueError("a surrogate is already attached")
        self.surrogate = offload
        alloc = Allocation(self.next_alloc_id(),
                           getattr(offload, "n_virtual_workers", 1),
                           None, virtual=True)
        alloc.submit(0.0, 0.0)                 # zero-queue-wait by design
        self._surrogate_id = alloc.alloc_id
        self._allocs[alloc.alloc_id] = alloc
        self._queues[alloc.alloc_id] = make_policy("fcfs", self.predictor)
        self.invalidate_allocations()
        if self.tracer is not None:
            offload.tracer = self.tracer
            self.tracer.alloc_state(alloc)
        return alloc

    def _surrogate_open(self) -> bool:
        sid = self._surrogate_id
        return (self.surrogate is not None and sid in self._allocs
                and self._allocs[sid].open)

    # -- allocation management ------------------------------------------
    def next_alloc_id(self) -> int:
        return next(self._ids)

    def invalidate_allocations(self) -> None:
        """Drop the cached allocation views.  Callers that change an
        allocation's routability OUTSIDE the broker's own methods — the
        stepper's `Allocation.tick` transitions, a manual `drain`/
        `terminate` — must call this; add/drain/remove on the broker bump
        the epoch themselves."""
        self._alloc_epoch += 1

    def allocations(self) -> List[Allocation]:
        """All registered allocations, sorted by id.  Cached between
        allocation-table changes (routing and autoalloc probes ask on
        every decision) — treat the returned list as read-only."""
        if self._sorted_epoch != self._alloc_epoch:
            self._sorted_cache = sorted(self._allocs.values(),
                                        key=lambda a: a.alloc_id)
            self._sorted_epoch = self._alloc_epoch
        return self._sorted_cache

    def allocation(self, alloc_id: int) -> Optional[Allocation]:
        return self._allocs.get(alloc_id)

    def add_allocation(self, alloc: Allocation) -> Allocation:
        self._allocs[alloc.alloc_id] = alloc
        self._queues[alloc.alloc_id] = self._make_queue()
        self.invalidate_allocations()
        if self.tracer is not None:
            self.tracer.alloc_state(alloc)
        self._flush_unrouted()
        return alloc

    def drain_allocation(self, alloc_id: int, now: float) -> None:
        """No new tasks; migrate its queued work to the rest of the
        cluster (running tasks are the owner's problem — the executor /
        simulator terminates the group once they finish)."""
        alloc = self._allocs.get(alloc_id)
        if alloc is None:
            return
        alloc.drain(now)
        self.invalidate_allocations()
        if self.tracer is not None:
            self.tracer.alloc_state(alloc, ts=now)
        self._migrate_off(alloc_id)

    def remove_allocation(self, alloc_id: int, now: float) -> None:
        """Allocation expired or was torn down: migrate queued tasks and
        forget it (warm-server affinities die with the node group)."""
        alloc = self._allocs.get(alloc_id)
        if alloc is None:
            return
        alloc.terminate(now)
        self.invalidate_allocations()          # closed before migration...
        if self.tracer is not None:
            self.tracer.alloc_state(alloc, ts=now)
        self._migrate_off(alloc_id)
        self._queues.pop(alloc_id, None)
        del self._allocs[alloc_id]             # caller keeps it for records
        self.invalidate_allocations()          # ...gone after it

    def _migrate_off(self, alloc_id: int) -> None:
        q = self._queues.get(alloc_id)
        self._affinity = {m: a for m, a in self._affinity.items()
                          if a != alloc_id}
        if q is None:
            return
        items = []
        item = q.pop()
        while item is not None:
            items.append(item)
            item = q.pop()
        for req, attempt in items:
            if self.tracer is not None:
                # a migrated task is the SAME queue entry rerouted — no
                # fresh task.queued instant, its wait keeps accruing
                self.tracer.instant("task.migrate",
                                    args={"task": req.task_id,
                                          "from": alloc_id})
            self._note_dequeue(req, attempt)   # re-enters via _route_push
            self._route_push(req, attempt)

    # -- routing ---------------------------------------------------------
    def _open_ids(self) -> List[int]:
        """Open REAL allocations — the virtual surrogate allocation is
        never a routing / stealing / least-loaded target; tasks reach it
        only through the offload decision.  Cached with `allocations()`
        behind the epoch counter: routing consults this on every push."""
        if self._open_epoch != self._alloc_epoch:
            self._open_cache = [a.alloc_id for a in self.allocations()
                                if a.open and not a.virtual]
            self._open_epoch = self._alloc_epoch
        return self._open_cache

    def _load(self, alloc_id: int) -> float:
        """Queued tasks per worker — O(1), deliberately NOT cost-based:
        routing and stealing run on every push / idle-worker poll under
        the dispatch lock, where an O(pending) predictor sweep would
        stall dispatch (backlog_cost caches for the same reason)."""
        q = self._queues.get(alloc_id)
        if q is None:
            return 0.0
        return len(q) / max(self._allocs[alloc_id].n_workers, 1)

    def _route(self, req) -> Optional[int]:
        open_ids = self._open_ids()
        if not open_ids:
            return None
        aff = self._affinity.get(req.model_name)
        if aff is not None and aff in open_ids:
            return aff
        chosen = min(open_ids, key=lambda i: (self._load(i), i))
        self._affinity.setdefault(req.model_name, chosen)
        return chosen

    def _route_push(self, req, attempt: int) -> None:
        # surrogate offload first: a trusted task never queues for real
        # capacity.  Its (predicted) cost is deliberately kept OUT of the
        # backlog ledger — the autoallocator must not size real node
        # groups for work the surrogate serves in milliseconds.  The cost
        # (possibly a GP inference) is computed ONCE and reused by the
        # ledger: push runs under the dispatch lock.
        cost = self.cost(req)
        if self._surrogate_open() and self.surrogate.decide(req, cost=cost):
            self._queues[self._surrogate_id].push(req, attempt)
            return
        self._note_enqueue(req, attempt, cost=cost)
        target = self._route(req)
        if target is None:
            self._unrouted.append((req, attempt))
        else:
            self._queues[target].push(req, attempt)

    def _flush_unrouted(self) -> None:
        if not self._unrouted or not self._open_ids():
            return
        items, self._unrouted = list(self._unrouted), deque()
        for req, attempt in items:
            self._note_dequeue(req, attempt)   # re-enters via _route_push
            self._route_push(req, attempt)

    # -- SchedulingPolicy protocol ---------------------------------------
    def push(self, req, attempt: int) -> None:
        if self.tracer is not None:
            self.tracer.task_queued(req.task_id, attempt, req=req)
        self._route_push(req, attempt)

    def pop(self, worker: Optional[WorkerView] = None
            ) -> Optional[QueueItem]:
        item = self._pop_inner(worker)
        if item is not None:
            self._note_dequeue(item[0], item[1])
        return item

    def _pop_inner(self, worker: Optional[WorkerView]
                   ) -> Optional[QueueItem]:
        self._flush_unrouted()
        if worker is None or worker.alloc_id is None:
            # anonymous consumer (snapshot draining, legacy pools): any
            # task — surrogate queue first, it is milliseconds of work
            if self._surrogate_id is not None and \
                    self._surrogate_id in self._queues:
                item = self._queues[self._surrogate_id].pop()
                if item is not None:
                    return item
            for i in self._open_ids():
                item = self._queues[i].pop()
                if item is not None:
                    return item
            return self._unrouted.popleft() if self._unrouted else None
        alloc = self._allocs.get(worker.alloc_id)
        if alloc is None or alloc.state != RUNNING:
            return None                        # draining/expired: no new work
        item = self._queues[worker.alloc_id].pop(worker)
        if item is not None:
            return item
        return self._steal(worker)

    def _steal(self, worker: WorkerView) -> Optional[QueueItem]:
        thief = self._allocs.get(worker.alloc_id)
        if thief is not None and thief.virtual:
            return None                        # surrogate serves only its own
        victims = [i for i in self._open_ids() if i != worker.alloc_id
                   and len(self._queues[i])]
        if not victims:
            return None
        victim = max(victims, key=lambda i: (self._load(i), -i))
        item = self._queues[victim].pop()
        if item is None:
            return None
        req, attempt = item
        self._affinity[req.model_name] = worker.alloc_id
        if self.tracer is not None:
            self.tracer.instant("task.steal",
                                args={"task": req.task_id,
                                      "from": victim,
                                      "to": worker.alloc_id})
        return req, attempt

    def pending(self) -> List[QueueItem]:
        out: List[QueueItem] = list(self._unrouted)
        for i in sorted(self._queues):
            out.extend(self._queues[i].pending())
        return out

    def __len__(self) -> int:
        return len(self._unrouted) + sum(len(q)
                                         for q in self._queues.values())

    def remove_worker(self, wid: int) -> None:
        for q in self._queues.values():
            q.remove_worker(wid)

    # -- autoalloc instrumentation ---------------------------------------
    def queued_on(self, alloc_id: int) -> int:
        q = self._queues.get(alloc_id)
        return len(q) if q is not None else 0

    def backlog_count(self) -> int:
        """Queued tasks waiting for REAL capacity (the surrogate's
        private queue is excluded, exactly as `backlog_cost` excludes its
        costs) — the count the legacy count-based autoscale trigger
        should scale on."""
        n = len(self)
        if self._surrogate_id is not None:
            n -= self.queued_on(self._surrogate_id)
        return n

    def tenant_backlogs(self) -> Dict[str, int]:
        """Queued tasks per tenant, summed across every real
        per-allocation queue plus the unrouted buffer.  Empty when no
        per-allocation policy is tenant-aware (i.e. anything but
        "fairshare") — per-tenant gauges then simply don't exist, so the
        single-tenant observability surface is unchanged."""
        out: Dict[str, int] = {}
        aware = False
        for i in sorted(self._queues):
            if i == self._surrogate_id:
                continue
            fn = getattr(self._queues[i], "tenant_pending_all", None)
            if callable(fn):
                aware = True
                for tenant, n in fn().items():
                    out[tenant] = out.get(tenant, 0) + n
        if aware:
            for req, _ in self._unrouted:
                tenant = getattr(req, "tenant", "") or "default"
                out[tenant] = out.get(tenant, 0) + 1
        return out

    def backlog_cost(self, default: float = 1.0) -> float:
        """Total queued seconds of work cluster-wide (predictor estimate,
        else time_request hint, else `default` per task) — the signal the
        `AutoAllocator` scales on.

        Maintained incrementally (the executor's monitor asks every 50 ms
        under the dispatch lock, where an O(queue) sweep of GP predictions
        would stall dispatch); the only O(queue) rebuild is when the
        predictor version token changes — the GP bumps it on posterior
        installs, not on every observation."""
        self.default_cost = default
        v = self._predictor_version()
        if v != self._cost_version:
            self._cost_version = v
            self._item_costs = {}
            self._cost_total = 0.0
            # rebuild over REAL queues only: surrogate-routed work is
            # never in the ledger (see _route_push)
            items: List[QueueItem] = list(self._unrouted)
            for i in sorted(self._queues):
                if i != self._surrogate_id:
                    items.extend(self._queues[i].pending())
            for req, attempt in items:
                self._note_enqueue(req, attempt)
        return max(self._cost_total, 0.0)

    def _note_enqueue(self, req, attempt: int,
                      cost: Optional[float] = None) -> None:
        key = (req.task_id, attempt)
        entry = self._item_costs.get(key)
        if entry is not None:                  # duplicate copy: reuse cost
            c, n = entry
            self._item_costs[key] = (c, n + 1)
        else:
            c = (cost if cost is not None else self.cost(req)) \
                or self.default_cost
            self._item_costs[key] = (c, 1)
        self._cost_total += c

    def _note_dequeue(self, req, attempt: int) -> None:
        entry = self._item_costs.get((req.task_id, attempt))
        if entry is None:
            return
        c, n = entry
        self._cost_total -= c
        if n <= 1:
            del self._item_costs[(req.task_id, attempt)]
        else:
            self._item_costs[(req.task_id, attempt)] = (c, n - 1)
