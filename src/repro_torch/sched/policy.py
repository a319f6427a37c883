"""Pluggable scheduling policies for the UQ task queue.

One `SchedulingPolicy` object is the queue: the live `Executor`'s worker
threads and the discrete-event `simulate_policy` loop both push submitted
requests into it and pop the next request to run — the SAME objects drive
both, so a policy can be validated deterministically in simulation before
it schedules real work.

Policies see an optional `WorkerView` at pop time (who is asking: which
model servers it already has warm, how much of its allocation remains) and
an optional `RuntimePredictor` for per-task cost estimates.  Cost fallback
order: predictor estimate -> the request's `time_request` hint (HQ's
static per-job hint) -> 0.

Implementations:
  * `FCFSPolicy`      — arrival order (the repo's former hard-coded queue).
  * `SJFPolicy`       — shortest predicted job first (minimises mean wait;
                        what `pack_by_cost=True` used to approximate with
                        the static time request).
  * `LPTPolicy`       — longest predicted job first (classic 4/3-approx
                        list scheduling for makespan on parallel workers).
  * `PackingPolicy`   — LPT order + allocation awareness, generalising
                        HQ's time-request/time-limit split: a worker near
                        the end of its bulk allocation is handed the
                        longest task that still FITS its remaining budget,
                        so short tasks backfill the allocation tail.
  * `WorkStealingPolicy` — locality-aware per-worker queues: tasks follow
                        the worker holding a warm server for their model
                        (skipping the ~1 s re-init the paper measures);
                        idle workers steal from the most loaded peer.

Thread-safety: the executor serialises push/pop under its own lock, so
policies are plain data structures (and stay deterministic in simulation).
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
import math
from collections import deque
from typing import TYPE_CHECKING, Deque, Dict, List, Optional, Tuple

from repro_torch.sched.costq import SortedCostQueue
from repro_torch.sched.registry import make_policy, register_policy

if TYPE_CHECKING:                              # hint-only: keeps repro_torch.sched
    from repro_torch.core.task import EvalRequest    # import-cycle-free

QueueItem = Tuple["EvalRequest", int]          # (request, attempt)


@dataclasses.dataclass(frozen=True)
class WorkerView:
    """What a policy may know about the worker asking for work."""
    wid: int = -1
    warm_models: frozenset = frozenset()       # models with a live server
    budget_left: Optional[float] = None        # seconds left in allocation
    alloc_id: Optional[int] = None             # owning allocation (cluster)


class SchedulingPolicy:
    """Queue interface shared by the live executor and the simulator."""

    name = "base"

    def __init__(self, predictor=None):
        self.predictor = predictor
        self._tick = itertools.count()         # deterministic FIFO tiebreak

    def bind(self, predictor) -> "SchedulingPolicy":
        """Attach a runtime predictor (no-op if one is already set)."""
        if predictor is not None and self.predictor is None:
            self.predictor = predictor
        return self

    def cost(self, req: EvalRequest) -> float:
        """Estimated compute seconds: predictor, else time_request, else 0."""
        if self.predictor is not None:
            c = self.predictor.predict(req)
            if c is not None:
                return float(c)
        if req.time_request:
            return float(req.time_request)
        return 0.0

    def costs(self, reqs: List[EvalRequest]) -> List[float]:
        """Vectorized `cost` over a whole queue — the bulk re-costing
        path.  Predictors exposing `predict_many` (both shipped ones do)
        score the batch in one pass: the GP predictor routes it through
        `gp.predict_batch`, so re-costing a 100k-task queue is a handful
        of fixed-shape fused launches instead of 100k single predicts.
        Third-party policies should call this (never a per-item `cost`
        loop) whenever they re-score more than a few requests at once."""
        ests: Optional[List[Optional[float]]] = None
        if self.predictor is not None:
            many = getattr(self.predictor, "predict_many", None)
            if callable(many):
                ests = many(reqs)
            else:
                ests = [self.predictor.predict(r) for r in reqs]
        out: List[float] = []
        for i, req in enumerate(reqs):
            c = ests[i] if ests is not None else None
            if c is not None:
                out.append(float(c))
            elif req.time_request:
                out.append(float(req.time_request))
            else:
                out.append(0.0)
        return out

    def _predictor_version(self) -> object:
        """Opaque token that changes when predictions may have changed —
        `version()` where available (the GP bumps it only on posterior
        updates, so O(queue) re-costing doesn't run on every pop),
        falling back to the observation count.  Shared by the cost-
        ordered heaps and the broker's backlog-cost cache."""
        v = getattr(self.predictor, "version", None)
        if callable(v):
            return v()
        n = getattr(self.predictor, "n_observed", None)
        return n() if callable(n) else 0

    # -- queue protocol -------------------------------------------------
    def push(self, req: EvalRequest, attempt: int) -> None:
        raise NotImplementedError

    def pop(self, worker: Optional[WorkerView] = None) -> Optional[QueueItem]:
        raise NotImplementedError

    def pending(self) -> List[QueueItem]:
        """Snapshot of queued items (checkpointing; no pops)."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def remove_worker(self, wid: int) -> None:
        """A worker left the pool (death, descale): policies holding
        per-worker state must reflow it so no queued task is stranded."""


@register_policy("fcfs")
class FCFSPolicy(SchedulingPolicy):
    """First-come-first-served — the baseline every dispatch path used."""

    name = "fcfs"

    def __init__(self, predictor=None):
        super().__init__(predictor)
        self._q: Deque[QueueItem] = deque()

    def push(self, req, attempt):
        self._q.append((req, attempt))

    def pop(self, worker=None):
        return self._q.popleft() if self._q else None

    def pending(self):
        return list(self._q)

    def __len__(self):
        return len(self._q)


class _CostOrderedPolicy(SchedulingPolicy):
    """Sorted store on (sign * cost, arrival tick): sign=+1 -> SJF,
    -1 -> LPT.

    Costs are evaluated at push time and lazily RE-evaluated whenever the
    predictor has absorbed new completions since the store was last built —
    so a queue submitted up front (the UQ batch pattern) still benefits
    from runtime estimates learned online during the run.  The rebuild
    re-scores the WHOLE queue through `costs()` (one batched predictor
    pass), and the `SortedCostQueue` keeps every subsequent pop — ordered
    or budget-fit — O(log n) at any queue size.
    """

    sign = 1.0

    def __init__(self, predictor=None):
        super().__init__(predictor)
        self._q = SortedCostQueue()
        self._built_version: object = None

    def _maybe_rebuild(self):
        if self.predictor is None or not len(self._q):
            return
        v = self._predictor_version()
        if v != self._built_version:
            old = self._q.entries()
            reqs = [item[0] for _, _, item in old]
            new_costs = self.costs(reqs)
            self._q.rebuild([(self.sign * c, tick, item)
                             for c, (_, tick, item) in zip(new_costs, old)])
            self._built_version = v

    def push(self, req, attempt):
        self._q.insert(self.sign * self.cost(req), next(self._tick),
                       (req, attempt))

    def pop(self, worker=None):
        self._maybe_rebuild()
        entry = self._q.pop_first()
        return entry[2] if entry is not None else None

    def pending(self):
        return [item for _, _, item in self._q]

    def __len__(self):
        return len(self._q)


@register_policy("sjf")
class SJFPolicy(_CostOrderedPolicy):
    """Shortest predicted job first."""
    name = "sjf"
    sign = 1.0


@register_policy("lpt")
class LPTPolicy(_CostOrderedPolicy):
    """Longest predicted job first."""
    name = "lpt"
    sign = -1.0


@register_policy("pack")
class PackingPolicy(_CostOrderedPolicy):
    """Cost-aware allocation packing.

    LPT ordering, but a worker with finite `budget_left` gets the longest
    task that fits its remaining allocation (plus `init_margin` for server
    startup).  If nothing fits, the shortest task is handed out anyway —
    progress beats idling, and the time *limit* still bounds the overrun.
    This generalises HQ's split between the time request (packing hint)
    and the time limit (kill bound).

    `risk_lambda` opts into uncertainty-aware packing: when the predictor
    exposes `predict_many_with_sd`, every queue key (and so every
    budget-fit comparison) becomes mean + λ·posterior-sd, so a task whose
    runtime the surrogate is unsure about must fit the allocation tail
    with λ sigmas to spare — an uncertain 50 s estimate stops being
    packed as if it were a certain one, which is what turns predictor
    variance into fewer time-limit kills.  The default λ=0 keeps the
    mean-only reference path bit-for-bit (the risk branch is never
    entered), and predictors without sd support fall back to means.
    """

    name = "pack"
    sign = -1.0

    def __init__(self, predictor=None, init_margin: float = 1.0,
                 risk_lambda: float = 0.0):
        super().__init__(predictor)
        self.init_margin = init_margin
        self.risk_lambda = risk_lambda

    def _with_sd(self):
        """The predictor's batched (mean, sd) hook, when risk-adjusted
        costing is both enabled and available."""
        if not self.risk_lambda or self.predictor is None:
            return None
        many = getattr(self.predictor, "predict_many_with_sd", None)
        return many if callable(many) else None

    def cost(self, req: EvalRequest) -> float:
        many = self._with_sd()
        if many is None:
            return super().cost(req)
        mean, sd = many([req])[0]
        if mean is None:
            return float(req.time_request) if req.time_request else 0.0
        return float(mean) + self.risk_lambda * float(sd or 0.0)

    def costs(self, reqs: List[EvalRequest]) -> List[float]:
        many = self._with_sd()
        if many is None:
            return super().costs(reqs)
        out: List[float] = []
        for (mean, sd), req in zip(many(reqs), reqs):
            if mean is not None:
                out.append(float(mean) + self.risk_lambda * float(sd or 0.0))
            elif req.time_request:
                out.append(float(req.time_request))
            else:
                out.append(0.0)
        return out

    def pop(self, worker=None):
        self._maybe_rebuild()
        if not len(self._q):
            return None
        if worker is None or worker.budget_left is None:
            return self._q.pop_first()[2]
        budget = worker.budget_left - self.init_margin
        # keys are -cost: the first entry at key >= -budget is the
        # LONGEST task with cost <= budget (earliest arrival among ties)
        entry = self._q.pop_first_at_least(-budget)
        if entry is None:                      # nothing fits: shortest
            entry = self._q.pop_last()         # (latest arrival on ties —
        return entry[2]                        # the old sorted()[-1] rule)


@register_policy("edf")
class EDFPolicy(SchedulingPolicy):
    """Earliest-deadline-first: SLO-aware ordering once requests carry a
    `deadline` (absolute seconds on the scheduler's clock).  Deadline-less
    requests sort after every deadlined one, FIFO among themselves —
    best-effort work never starves an SLO."""

    name = "edf"

    def __init__(self, predictor=None):
        super().__init__(predictor)
        self._heap: List[Tuple[float, int, QueueItem]] = []

    def push(self, req, attempt):
        key = req.deadline if getattr(req, "deadline", None) is not None \
            else float("inf")
        heapq.heappush(self._heap, (key, next(self._tick), (req, attempt)))

    def pop(self, worker=None):
        return heapq.heappop(self._heap)[2] if self._heap else None

    def pending(self):
        return [item for _, _, item in sorted(self._heap)]

    def __len__(self):
        return len(self._heap)


@register_policy("steal")
class WorkStealingPolicy(SchedulingPolicy):
    """Locality-aware work stealing.

    Each worker owns a local deque.  A request whose model already has an
    affinity (a worker that ran it before, hence holds a warm server under
    persistent-server semantics) is queued locally on that worker; others
    go to a shared global deque.  A worker pops its own queue first, then
    takes a global task (preferring one whose model it has warm), then
    steals from the back of the most loaded peer — the classic stealing
    end, so locality of the victim's imminent work is preserved.

    The global queue is doubly indexed for million-task queues: the
    arrival deque gives FIFO pops, and a per-model index of the same
    entry objects answers "earliest pending task of a warm model" by
    peeking O(warm models) deque heads — the old implementation scanned
    the whole deque per pop and paid an O(n) `del` on a match.  An entry
    taken through one view is tombstoned (`alive=False`) and dropped
    lazily when the other view reaches it.  Worker iteration (anonymous
    drains, steal-victim ties) is by ascending wid, never dict insertion
    order, so sim/live parity cannot depend on which worker popped first
    in history.
    """

    name = "steal"

    # a global-queue entry, shared by the FIFO deque and the model index
    # ([seq, req, attempt, alive] — a list so `alive` is mutable in place)
    _SEQ, _REQ, _ATTEMPT, _ALIVE = range(4)

    def __init__(self, predictor=None):
        super().__init__(predictor)
        self._local: Dict[int, Deque[QueueItem]] = {}
        self._global: Deque[list] = deque()    # FIFO view (seq ascending)
        self._by_model: Dict[str, Deque[list]] = {}    # per-model view
        self._n_global = 0                     # live entries in _global
        self._n_dead = 0                       # tombstones not yet dropped
        self._seq_back = itertools.count()     # arrival order keys
        self._seq_front = -1                   # reflowed-to-front keys
        self._affinity: Dict[str, int] = {}    # model name -> worker id

    def _push_global(self, req, attempt, *, front: bool = False) -> None:
        if front:
            seq, self._seq_front = self._seq_front, self._seq_front - 1
        else:
            seq = next(self._seq_back)
        entry = [seq, req, attempt, True]
        index = self._by_model.setdefault(req.model_name, deque())
        if front:
            self._global.appendleft(entry)
            index.appendleft(entry)
        else:
            self._global.append(entry)
            index.append(entry)
        self._n_global += 1

    def _take(self, entry) -> QueueItem:
        """Claim a live global entry: tombstone it for the view that did
        not hand it out (lazily skipped there later).  The payload is
        cleared immediately — a tombstone must never keep a served
        request's parameters alive — and once tombstones outnumber live
        entries both views are compacted, so memory tracks the LIVE
        queue, not every task ever pushed."""
        item = (entry[self._REQ], entry[self._ATTEMPT])
        entry[self._ALIVE] = False
        entry[self._REQ] = entry[self._ATTEMPT] = None
        self._n_global -= 1
        self._n_dead += 1
        if self._n_dead > 64 and self._n_dead > self._n_global:
            self._compact_global()
        return item

    def _compact_global(self) -> None:
        """Drop every tombstone from both global views (amortised O(1)
        per pop: runs only when dead entries dominate)."""
        self._global = deque(e for e in self._global if e[self._ALIVE])
        for model in list(self._by_model):
            q = deque(e for e in self._by_model[model] if e[self._ALIVE])
            if q:
                self._by_model[model] = q
            else:
                del self._by_model[model]
        self._n_dead = 0

    def _pop_global_fifo(self) -> Optional[QueueItem]:
        while self._global:
            entry = self._global.popleft()
            if entry[self._ALIVE]:
                return self._take(entry)
        return None

    def _pop_global_warm(self, worker: WorkerView) -> Optional[QueueItem]:
        """Earliest pending global task of any model the worker has warm
        — O(|warm_models|) head peeks on the per-model index."""
        best = None
        best_q = None
        for model in worker.warm_models:
            q = self._by_model.get(model)
            if not q:
                continue
            while q and not q[0][self._ALIVE]:     # lazy tombstone drop
                q.popleft()
            if q and (best is None or q[0][self._SEQ] < best[self._SEQ]):
                best, best_q = q[0], q
        if best is None:
            return None
        best_q.popleft()
        return self._take(best)

    def push(self, req, attempt):
        wid = self._affinity.get(req.model_name)
        if wid is not None and wid in self._local:
            self._local[wid].append((req, attempt))
        else:
            self._push_global(req, attempt)

    def pop(self, worker=None):
        if worker is None:                     # anonymous consumer
            item = self._pop_global_fifo()
            if item is not None:
                return item
            for wid in sorted(self._local):    # wid order, not dict order
                if self._local[wid]:
                    return self._local[wid].popleft()
            return None
        mine = self._local.setdefault(worker.wid, deque())
        if mine:
            return mine.popleft()
        if self._n_global:                     # prefer a warm-model task
            item = self._pop_global_warm(worker)
            if item is None:
                item = self._pop_global_fifo()
            self._affinity[item[0].model_name] = worker.wid
            return item
        victim = None
        for wid in sorted(self._local):        # largest backlog, lowest
            q = self._local[wid]               # wid among ties
            if wid != worker.wid and q and \
                    (victim is None or len(q) > len(victim)):
                victim = q
        if victim:
            req, attempt = victim.pop()        # steal from the back
            self._affinity[req.model_name] = worker.wid
            return req, attempt
        return None

    def pending(self):
        out = [(e[self._REQ], e[self._ATTEMPT]) for e in self._global
               if e[self._ALIVE]]
        for wid in sorted(self._local):
            out.extend(self._local[wid])
        return out

    def __len__(self):
        return self._n_global + sum(len(q) for q in self._local.values())

    def remove_worker(self, wid):
        """Reflow a gone worker's local tasks to the FRONT of the global
        queue (they arrived earliest) and drop its affinities, so nothing
        starves waiting for a worker that will never pop again."""
        q = self._local.pop(wid, None)
        if q:
            for req, attempt in reversed(q):   # appendleft keeps q's order
                self._push_global(req, attempt, front=True)
        self._affinity = {m: w for m, w in self._affinity.items()
                          if w != wid}


@register_policy("fairshare")
class FairSharePolicy(SchedulingPolicy):
    """Weighted fair sharing across tenants (deficit round robin).

    Composes one inner `SchedulingPolicy` per tenant — any registered
    name or zero-arg factory, sharing this policy's predictor — and
    serves pops by weighted deficit round robin over estimated
    cost-seconds: whenever no backlogged tenant holds credit, every
    backlogged tenant is credited ``quantum_s * weight`` per round
    (rounds batched in closed form, so one huge task can't make the
    replenish loop O(cost/quantum)); a pop serves the first
    credit-holding tenant after the last-served one in sorted tenant
    order, and charges the task's PUSH-TIME cost estimate against its
    deficit.  Consequences, both pinned by tests:

      * over any saturated stretch each tenant's served cost-seconds
        converge to its weight share (weighted max-min fairness);
      * a backlogged tenant is served at least ``quantum_s * weight``
        cost-seconds per round — bounded-delay, so bursty competitors
        can't starve anyone.

    Costs are cached at push (keyed ``(tenant, task_id, attempt)`` with
    duplicate counting for speculative re-pushes) so the pop hot path
    never touches the predictor — the same discipline the Broker's
    backlog ledger established.  Unknown/zero estimates charge
    ``default_cost`` so free-looking tasks still consume bandwidth.
    Classic DRR rule: a tenant whose queue empties forfeits banked
    credit (no saving up while idle).

    If every credit-holding tenant declines the asking worker (e.g. a
    budget-fit inner ``pack`` pop finds nothing that fits), the scan
    repeats ignoring credit — progress beats idling, and the charge
    still lands on the served tenant.

    Determinism: tenant ring order is sorted, the cursor is part of the
    state, and charges derive from push-time caches — identical
    push/pop sequences (the parity harness's guarantee) produce
    identical pop orders in sim and live.

    ``quotas`` (max queued tasks per tenant) are carried for admission
    layers: the policy itself never rejects work (queue contract), but
    `quota_headroom` is what `repro_torch.service.ServiceBroker` turns into
    per-tenant backpressure.
    """

    name = "fairshare"

    def __init__(self, predictor=None, policy="fcfs",
                 weights: Optional[Dict[str, float]] = None,
                 quotas: Optional[Dict[str, int]] = None,
                 quantum_s: float = 1.0, default_cost: float = 1.0):
        super().__init__(predictor)
        if isinstance(policy, SchedulingPolicy):
            raise TypeError(
                "FairSharePolicy builds one inner queue PER tenant: pass "
                "a registered policy name or a zero-arg factory, not an "
                "instance")
        if policy == "fairshare":
            raise TypeError("fairshare inside fairshare is not supported")
        self._sub_spec = policy
        self.weights = {str(t): float(w)
                        for t, w in (weights or {}).items()}
        for t, w in self.weights.items():
            if w <= 0:
                raise ValueError(f"tenant weight must be > 0: {t}={w}")
        self.quotas = {str(t): int(q) for t, q in (quotas or {}).items()}
        self.quantum_s = float(quantum_s)
        self.default_cost = float(default_cost)
        self._tenants: Dict[str, SchedulingPolicy] = {}
        self._ring: List[str] = []             # sorted tenant names
        self._cursor: Optional[str] = None     # last-served tenant
        self._deficit: Dict[str, float] = {}
        self._served: Dict[str, float] = {}    # cumulative charged cost
        self._backlog: Dict[str, float] = {}   # queued cost (push-time est)
        # (tenant, task_id, attempt) -> (cost, multiplicity)
        self._push_cost: Dict[Tuple[str, str, int], Tuple[float, int]] = {}

    @staticmethod
    def tenant_of(req) -> str:
        return getattr(req, "tenant", "") or "default"

    def bind(self, predictor):
        super().bind(predictor)
        for q in self._tenants.values():
            q.bind(self.predictor)
        return self

    def _weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    def _inner(self, tenant: str) -> SchedulingPolicy:
        q = self._tenants.get(tenant)
        if q is None:
            if callable(self._sub_spec) and \
                    not isinstance(self._sub_spec, str):
                q = self._sub_spec()
                q.bind(self.predictor)
            else:
                q = make_policy(self._sub_spec, self.predictor)
            self._tenants[tenant] = q
            bisect.insort(self._ring, tenant)
            self._deficit.setdefault(tenant, 0.0)
            self._served.setdefault(tenant, 0.0)
            self._backlog.setdefault(tenant, 0.0)
        return q

    # -- queue protocol -------------------------------------------------
    def push(self, req, attempt):
        tenant = self.tenant_of(req)
        inner = self._inner(tenant)
        key = (tenant, req.task_id, attempt)
        entry = self._push_cost.get(key)
        if entry is not None:                  # speculative duplicate:
            cost, n = entry                    # same charge both times
            self._push_cost[key] = (cost, n + 1)
        else:
            cost = self.cost(req)
            if cost <= 0.0:
                cost = self.default_cost
            self._push_cost[key] = (cost, 1)
        self._backlog[tenant] += cost
        inner.push(req, attempt)

    def _charge_of(self, tenant: str, req, attempt: int) -> float:
        key = (tenant, req.task_id, attempt)
        entry = self._push_cost.get(key)
        if entry is None:                      # never pushed here (migrated
            return self.default_cost           # in?): nominal charge
        cost, n = entry
        if n <= 1:
            del self._push_cost[key]
        else:
            self._push_cost[key] = (cost, n - 1)
        return cost

    def _replenish(self, active: List[str]) -> None:
        """Credit every backlogged tenant until at least one is positive
        — the number of quantum rounds computed in closed form, so a
        single task far larger than the quantum costs O(active), not
        O(cost / quantum)."""
        if any(self._deficit[t] > 0.0 for t in active):
            return
        rounds = min(
            math.floor(-self._deficit[t] / (self.quantum_s *
                                            self._weight(t))) + 1
            for t in active)
        for t in active:
            self._deficit[t] += rounds * self.quantum_s * self._weight(t)

    def _scan(self, active: List[str], worker,
              need_credit: bool) -> Optional[QueueItem]:
        if self._cursor is not None:           # resume after last served
            i = bisect.bisect_right(active, self._cursor)
            order = active[i:] + active[:i]
        else:
            order = active
        for tenant in order:
            if need_credit and self._deficit[tenant] <= 0.0:
                continue
            item = self._tenants[tenant].pop(worker)
            if item is None:
                continue
            req, attempt = item
            cost = self._charge_of(tenant, req, attempt)
            self._deficit[tenant] -= cost
            self._served[tenant] += cost
            self._backlog[tenant] = max(self._backlog[tenant] - cost, 0.0)
            self._cursor = tenant
            if not len(self._tenants[tenant]):
                self._deficit[tenant] = 0.0    # DRR: emptied -> no banking
            return item
        return None

    def pop(self, worker=None):
        active = [t for t in self._ring if len(self._tenants[t])]
        if not active:
            return None
        self._replenish(active)
        item = self._scan(active, worker, need_credit=True)
        if item is None:                       # every credit holder declined
            item = self._scan(active, worker, need_credit=False)
        return item

    def pending(self):
        out: List[QueueItem] = []
        for tenant in self._ring:
            out.extend(self._tenants[tenant].pending())
        return out

    def __len__(self):
        return sum(len(q) for q in self._tenants.values())

    def remove_worker(self, wid):
        for tenant in self._ring:
            self._tenants[tenant].remove_worker(wid)

    # -- tenant introspection (SLO accounting / admission) --------------
    def tenant_pending_all(self) -> Dict[str, int]:
        """Queued tasks per tenant (only tenants with backlog)."""
        return {t: len(q) for t, q in self._tenants.items() if len(q)}

    def tenant_backlog_cost(self) -> Dict[str, float]:
        """Queued cost-seconds per tenant, at push-time estimates (an
        SLO-accounting probe; the Broker's version-cached ledger remains
        the autoalloc signal)."""
        return {t: c for t, c in self._backlog.items()
                if len(self._tenants[t])}

    def served_cost(self) -> Dict[str, float]:
        """Cumulative charged cost-seconds per tenant — the quantity the
        fairness tests measure shares on."""
        return dict(self._served)

    def quota_headroom(self, tenant: str) -> Optional[int]:
        """How many more tasks `tenant` may queue under its quota (None
        = unlimited).  Advisory: enforced by admission layers, not by
        `push`."""
        quota = self.quotas.get(tenant)
        if quota is None:
            return None
        queued = len(self._tenants[tenant]) if tenant in self._tenants \
            else 0
        return max(quota - queued, 0)
