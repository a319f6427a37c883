"""`simulate_cluster`: deterministic discrete-event elasticity runs.

Where `simulate` reproduces the paper's queue-depth submission model and
`simulate_policy` models this repo's executor on a fixed worker pool,
`simulate_cluster` models the full allocation lifecycle: tasks ARRIVE
over virtual time (seeded traces from `repro_torch.cluster.traces`), a
`Broker` routes them between allocations, and an optional
`AutoAllocator` submits/drains bulk allocations as backlog cost moves —
the same Broker/AutoAllocator objects that drive the live `Executor`,
stepped on a virtual clock instead of `time.monotonic()`.

Semantics per allocation follow the HQ backend spec: one queue wait per
allocation (drawn from the `BackendSpec` overhead model), persistent
workers with warm model servers inside it, per-task `server_init` paid
once per (worker, model), ms-level dispatch.  Warm servers die with
their allocation; a task still running at walltime expiry is killed and
requeued (up to `max_attempts`), exactly the failure mode budget-aware
packing policies exist to avoid.

Everything is seeded end-to-end: same (trace, seed, config) -> identical
task records, allocation records, and autoalloc decisions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import device as device_mod
from repro_torch.chaos.inject import ChaosInjector
from repro_torch.chaos.speculate import find_stragglers
from repro_torch.cluster.allocation import (DRAINING, QUEUED, RUNNING,
                                            Allocation)
from repro_torch.cluster.autoalloc import AutoAllocConfig, AutoAllocator
from repro_torch.cluster.broker import Broker
from repro_torch.cluster.stepper import LifecycleStepper, StepperEvent
from repro_torch.cluster.traces import TraceTask
from repro_torch.core import metrics as _metrics
from repro_torch.core.backends import BackendSpec
from repro_torch.core.metrics import (AllocationRecord, TaskRecord,
                                killed_task_record,
                                quarantined_task_record)
from repro_torch.core.task import EvalRequest, RetryPolicy
from repro_torch.obs.attribution import attribute_overhead
from repro_torch.sched.policy import WorkerView
from repro_torch.sched.registry import make_predictor


@dataclasses.dataclass
class ClusterResult:
    """Everything a seeded run produced (all deterministically ordered).

    `events` is the stepper's spawn/retire audit trail
    (``(t, kind, alloc_id, n)``) — what the differential parity suite
    compares between the sim and live paths."""
    records: List[TaskRecord]
    allocations: List[AllocationRecord]
    decisions: List[Dict[str, Any]]
    events: List[StepperEvent] = dataclasses.field(default_factory=list)
    # per-task overhead decomposition (repro_torch.obs.attribute_overhead
    # output); populated only when the run was traced (``tracer=``)
    overhead_attribution: Optional[Dict[str, Any]] = None

    def summary(self) -> Dict[str, float]:
        done = [r for r in self.records if r.status == "ok"]
        return {
            "n_tasks": float(len(self.records)),
            "n_ok": float(len(done)),
            "makespan": _metrics.makespan(self.records),
            "node_seconds": _metrics.node_seconds(self.allocations),
            "utilization": _metrics.allocation_utilization(self.allocations),
            "n_allocations": float(len(self.allocations)),
        }


def trace_requests(trace: List[TraceTask], max_attempts: int,
                   retry: Any = None):
    """The one trace-to-request mapping both differential drivers use
    (`simulate_cluster` and `parity.replay_live`): time-sorted arrivals,
    task ids ``trace-<i>``, synthetic per-index payloads where the trace
    carries none, and ``submit_t`` pinned to the arrival time.  An
    optional `RetryPolicy` (or its dict form) is stamped on every
    request.  Returns ``(arrivals, requests, runtimes)``."""
    if isinstance(retry, dict):
        retry = RetryPolicy(**retry)
    arrivals = sorted(trace, key=lambda tt: (tt.t,))
    runtimes: Dict[str, float] = {}
    reqs: List[EvalRequest] = []
    for i, tt in enumerate(arrivals):
        req = EvalRequest(model_name=tt.model_name,
                          parameters=(tt.parameters
                                      if tt.parameters is not None
                                      else [[float(i)]]),
                          time_request=tt.time_request,
                          n_cpus=tt.n_cpus,
                          task_id=f"trace-{i}",
                          max_attempts=max_attempts,
                          tenant=getattr(tt, "tenant", "default"),
                          retry=retry)
        req.submit_t = tt.t        # after init: 0.0 must survive as-is
        runtimes[req.task_id] = tt.runtime
        reqs.append(req)
    return arrivals, reqs, runtimes


def next_event_time(arrivals, arr_i: int, busy_ends, broker,
                    elastic: bool, next_tick: float,
                    extra=()) -> Optional[float]:
    """The canonical next-event candidate set shared by both drivers:
    the next arrival, every in-flight completion, allocation grant and
    walltime-expiry times, and — while an allocator has anything left to
    react to — the autoalloc tick.  ``extra`` appends driver-supplied
    candidates (chaos fault fire times, deferred backoff releases): they
    must be event times or those instants drift off the parity trace.
    None means nothing can ever happen (the caller stops and surfaces
    unserved work as 'lost')."""
    candidates: List[float] = list(busy_ends)
    candidates.extend(extra)
    if arr_i < len(arrivals):
        candidates.append(arrivals[arr_i].t)
    for a in broker.allocations():
        if a.state == QUEUED:
            candidates.append(a.grant_t)
        elif a.state in (RUNNING, DRAINING) and math.isfinite(a.expiry_t):
            candidates.append(a.expiry_t)
    if elastic and (len(broker) or broker.allocations()
                    or arr_i < len(arrivals)):
        candidates.append(next_tick)
    return min(candidates) if candidates else None


def fill_lost(records: List[TaskRecord], reqs: List[EvalRequest],
              end: float, tracer: Any = None) -> None:
    """Tasks a run could never finish (e.g. a static pool whose only
    allocation expired with work still queued) MUST leave a record —
    silent loss would read as a smaller, fully-served workload."""
    finalized = {r.task_id for r in records}
    for req in reqs:
        if req.task_id not in finalized:
            records.append(TaskRecord(
                task_id=req.task_id, submit_t=req.submit_t,
                start_t=end, end_t=end, cpu_time=0.0, compute_t=0.0,
                worker="", attempts=0, status="lost"))
            if tracer is not None:
                tracer.task_lost(req.task_id, end)


class _SimWorker:
    __slots__ = ("wid", "alloc", "warm", "busy", "req", "attempt",
                 "mark_t", "start_t", "end_t", "compute", "init")

    def __init__(self, wid: int, alloc: Allocation):
        self.wid = wid
        self.alloc = alloc
        self.warm: set = set()
        self.busy = False
        self.req: Optional[EvalRequest] = None
        self.attempt = 1
        self.mark_t = 0.0    # dispatch decision time (busy-billing base)
        self.start_t = 0.0   # mark_t + dispatch latency
        self.end_t = 0.0
        self.compute = 0.0
        self.init = 0.0


def simulate_cluster(spec: BackendSpec, trace: List[TraceTask], *,
                     policy: Any = "fcfs", predictor: Any = None,
                     autoalloc: Any = None, broker: Optional[Broker] = None,
                     allocator: Optional[AutoAllocator] = None,
                     n_workers: int = 4,
                     walltime_s: Optional[float] = None,
                     max_workers: Optional[int] = None,
                     seed: int = 0, tick_s: float = 5.0,
                     max_attempts: int = 3,
                     max_t: float = 1e9,
                     tracer: Any = None,
                     registry: Any = None,
                     calibration: Any = None,
                     fault_plan: Any = None,
                     retry_policy: Any = None,
                     straggler_factor: float = 0.0,
                     straggler_min_completed: int = 5) -> ClusterResult:
    """Run one trace through brokered, allocation-backed dispatch.

    Two modes:
      * static (``autoalloc=None``): one allocation of `n_workers` for
        `walltime_s` (None = held until the run ends) — the fixed-pool
        baseline every elasticity comparison needs.  A broker that
        already carries a real allocation keeps it (the parity harness
        injects one matching the live executor's initial group);
      * elastic (``autoalloc=AutoAllocConfig(...)`` or an
        `AutoAllocator`): allocations are submitted and drained by the
        allocator; the run starts with zero capacity and bootstraps off
        the unrouted backlog.

    `max_workers` is the live executor's pool cap, enforced by the shared
    `LifecycleStepper` (grants resized to headroom, zero-headroom grants
    cancelled) and advertised to the allocator as its `worker_cap`; None
    (the default) leaves the sim uncapped and any caller-set `worker_cap`
    untouched.

    Pass `broker`/`allocator` instances to drive *the same objects* you
    later hand to a live `Executor` (the no-forked-logic guarantee).

    Trace replay: pass a `repro_torch.obs.replay.ReplayBackendSpec` (built
    from a recorded trace) as ``spec`` and the replay's reconstructed
    trace as ``trace`` — queue waits pop from the recorded FIFO through
    `draw_queue_wait` and per-model cold-init costs come from
    ``spec.server_init_for`` (consulted here when the spec provides it),
    so a sim-recorded trace reproduces its original records exactly.
    ``calibration=`` accepts a `repro_torch.obs.calib.CalibrationMonitor`:
    observed per-attempt overheads and granted queue waits are streamed
    into it for online drift detection, exactly as the live `Executor`
    does.

    Chaos & recovery (all seeded, all mirrored by `parity.replay_live`):
    ``fault_plan=`` takes a `repro_torch.chaos.FaultPlan` whose events fire at
    the stepper choke point — worker crashes, allocation preemption with
    a grace-period drain (in-flight work migrates), slow-node compute
    degradation, result corruption, surrogate outages.  ``retry_policy=``
    stamps a `RetryPolicy` on every request: failed attempts requeue
    after deterministic exponential backoff (+ seeded jitter) and
    worker-killing failures quarantine the task after
    ``quarantine_after`` strikes.  ``straggler_factor>0`` arms
    speculative re-execution: when the queue is drained and idle
    capacity exists, tasks running past their model's p95 cutoff
    (`repro_torch.chaos.find_stragglers`) are hedged on a spare worker —
    first completion wins, the loser is cancelled and its partial work
    billed to the allocation.
    """
    rng = np.random.default_rng(seed)
    if broker is None:
        broker = Broker(predictor=make_predictor(predictor), policy=policy)
    surrogate_dev = getattr(broker.surrogate, "device", None)
    if surrogate_dev is not None:
        # the offload's GP runs where its engine lives, which must be the
        # port's device: no card under the default device raises here
        device_mod.check(surrogate_dev)
    if allocator is None and autoalloc is not None:
        if isinstance(autoalloc, AutoAllocator):
            allocator = autoalloc              # same-objects contract
        else:
            if isinstance(autoalloc, AutoAllocConfig):
                cfg = autoalloc
            elif isinstance(autoalloc, dict):
                cfg = AutoAllocConfig(**autoalloc)
            else:
                raise TypeError(f"autoalloc= expects an AutoAllocConfig, "
                                f"dict, or AutoAllocator; got {autoalloc!r}")
            allocator = AutoAllocator(cfg, spec=spec, seed=seed)

    arrivals, reqs, runtimes = trace_requests(trace, max_attempts,
                                              retry_policy)

    now = 0.0
    if tracer is not None:
        # the tracer stamps with the virtual event time — the live
        # executor binds its own injected clock, so parity replays of
        # the same trace produce identical span timestamps
        tracer.bind_clock(lambda: now)
        # the spec's exact overhead constants, recorded so a replay of
        # this trace uses the same floats (span durs are endpoint
        # differences and lose the last ulp); parity.replay_live emits
        # the identical instant, keeping span sequences comparable
        tracer.instant("trace.spec", ts=0.0, args={
            "backend": spec.name,
            "dispatch_latency": float(spec.dispatch_latency),
            "server_init": float(spec.server_init),
            "queue_wait_sigma": float(spec.queue_wait_sigma)})
        broker.set_tracer(tracer)

    if allocator is None and not any(not a.virtual
                                     for a in broker.allocations()):
        static = Allocation(broker.next_alloc_id(), n_workers, walltime_s)
        request_s = static.walltime_s
        static.submit(0.0, spec.draw_queue_wait(rng, request_s))
        broker.add_allocation(static)
    if allocator is not None and max_workers is not None:
        allocator.worker_cap = max_workers     # live-executor semantics

    workers: Dict[int, _SimWorker] = {}
    wid_counter = 0
    records: List[TaskRecord] = []
    n_final = 0                                # tasks with a final record
    done_ids: set = set()                      # tasks with a terminal record
    real_done: List[tuple] = []                # (model, compute) of real oks
    arr_i = 0
    next_tick = 0.0
    retired: List[Allocation] = []             # keep records of removed allocs

    # dispatch scans workers in (alloc_id, wid) order on EVERY event;
    # the order only changes when a group spawns or retires, so the
    # sorted list is cached and rebuilt on membership changes instead of
    # re-sorted per event (O(W log W) off the inner loop)
    order_cache: List[_SimWorker] = []
    order_dirty = [True]

    def dispatch_order() -> List[_SimWorker]:
        if order_dirty[0]:
            order_cache[:] = sorted(workers.values(),
                                    key=lambda w: (w.alloc.alloc_id, w.wid))
            order_dirty[0] = False
        return order_cache

    # ---- stepper adapter: mechanism callbacks over the sim worker table
    def spawn_workers(alloc: Allocation):
        nonlocal wid_counter
        for _ in range(alloc.n_workers):
            workers[wid_counter] = _SimWorker(wid_counter, alloc)
            wid_counter += 1
        order_dirty[0] = True

    def retire_workers(alloc: Allocation):
        killed = []
        for w in sorted(list(workers.values()), key=lambda w: w.wid):
            if w.alloc is not alloc:
                continue
            if w.busy:
                killed.append((w.req, w.attempt, w.mark_t))
            broker.remove_worker(w.wid)
            del workers[w.wid]
        order_dirty[0] = True
        return killed

    def busy_count():
        busy: Dict[int, int] = {}
        for w in workers.values():
            if w.busy:
                busy[w.alloc.alloc_id] = busy.get(w.alloc.alloc_id, 0) + 1
        return busy

    def cancel_copies(task_id, t):
        # a task just reached a terminal state: any OTHER in-flight copy
        # (a speculative hedge, or the original of a hedge that lost) is
        # cancelled — its partial work bills to its allocation and the
        # hedge_cancel instant feeds conservation accounting
        for w in sorted((w for w in workers.values()
                         if w.busy and w.req.task_id == task_id),
                        key=lambda w: w.wid):
            w.alloc.note_busy(max(t - w.mark_t, 0.0))
            if tracer is not None:
                tracer.task_hedge_cancel(task_id, w.attempt, t, w.mark_t)
            w.busy, w.req = False, None

    def record_failed(req, attempt, alloc, t):
        nonlocal n_final
        records.append(killed_task_record(req.task_id, req.submit_t, t,
                                          alloc.alloc_id, attempt))
        n_final += 1
        done_ids.add(req.task_id)
        cancel_copies(req.task_id, t)

    def record_quarantined(req, attempt, alloc, t):
        nonlocal n_final
        records.append(quarantined_task_record(req.task_id, req.submit_t, t,
                                               alloc.alloc_id, attempt))
        n_final += 1
        done_ids.add(req.task_id)
        cancel_copies(req.task_id, t)

    stepper = LifecycleStepper(
        broker, allocator, now=lambda: now,
        spawn_workers=spawn_workers, retire_workers=retire_workers,
        busy_count=busy_count,
        worker_count=lambda: len([w for w in workers.values()
                                  if not w.alloc.virtual]),
        record_failed=record_failed, record_quarantined=record_quarantined,
        max_workers=max_workers, max_attempts=None, retired=retired,
        tracer=tracer, registry=registry, calibration=calibration,
        retry_seed=seed)

    # ---- chaos: handlers mutate the sim worker/allocation tables at the
    # stepper choke point, so a parity replay (whose handlers mutate the
    # live executor's tables) observes the identical fault sequence
    chaos: Optional[ChaosInjector] = None
    if fault_plan is not None and len(fault_plan):
        chaos = ChaosInjector(fault_plan, tracer=tracer)

        def _crash(ev, t):
            busy = sorted((w for w in workers.values()
                           if w.busy and not w.alloc.virtual),
                          key=lambda w: (w.alloc.alloc_id, w.wid))
            if not busy:
                return
            w = busy[ev.target % len(busy)]
            req, attempt, mark = w.req, w.attempt, w.mark_t
            w.alloc.note_busy(max(t - mark, 0.0))
            w.warm.clear()           # worker process restart: servers cold
            w.busy, w.req = False, None
            stepper.requeue_or_fail(req, attempt, mark, t, w.alloc,
                                    fatal=True)

        def _preempt(ev, t):
            allocs = sorted((a for a in broker.allocations()
                             if not a.virtual and a.state == RUNNING),
                            key=lambda a: a.alloc_id)
            if not allocs:
                return
            victim = allocs[ev.target % len(allocs)]
            deadline = t + ev.duration_s
            if deadline < victim.expiry_t:
                victim.walltime_s = deadline - victim.grant_t
            broker.drain_allocation(victim.alloc_id, t)
            # in-flight work that cannot finish inside the grace window
            # migrates NOW (same attempt — migration is not a failure)
            for w in sorted((w for w in workers.values()
                             if w.busy and w.alloc is victim
                             and w.end_t > deadline),
                            key=lambda w: w.wid):
                req, attempt, mark = w.req, w.attempt, w.mark_t
                w.alloc.note_busy(max(t - mark, 0.0))
                w.busy, w.req = False, None
                stepper.requeue_or_fail(req, attempt, mark, t, victim,
                                        migrate=True)

        def _slow(ev, t):
            cand = sorted((w for w in workers.values()
                           if not w.alloc.virtual
                           and w.alloc.state == RUNNING),
                          key=lambda w: (w.alloc.alloc_id, w.wid))
            if cand:
                w = cand[ev.target % len(cand)]
                chaos.set_slow(w.wid, ev.factor, t + ev.duration_s)

        def _outage(ev, t):
            sur = getattr(broker, "surrogate", None)
            if sur is not None and hasattr(sur, "set_degraded"):
                sur.set_degraded(t, t + ev.duration_s, "outage")

        chaos.on("worker_crash", _crash)
        chaos.on("preempt", _preempt)
        chaos.on("slow_node", _slow)
        chaos.on("surrogate_outage", _outage)
        # journal_torn: the sim has no journal — a symmetric no-op (the
        # chaos.fire instant still lands on the trace for parity)
        stepper.chaos = chaos

    # ---- speculative re-execution: when the queue is drained and idle
    # real capacity exists, hedge tasks running past their model's p95
    def hedge_check(t):
        if straggler_factor <= 0.0 or len(broker) != 0:
            return
        idle = [w for w in workers.values()
                if not w.busy and not w.alloc.virtual
                and w.alloc.state == RUNNING]
        if not idle:
            return
        cands = sorted((w for w in workers.values()
                        if w.busy and not w.req.config.get("_surrogate")
                        and not w.req.config.get("_speculated")),
                       key=lambda w: (w.mark_t, w.req.task_id))
        ids = find_stragglers(
            t, [(w.req.task_id, w.req.model_name, w.mark_t)
                for w in cands],
            real_done, predictor=broker.predictor,
            factor=straggler_factor, min_n=straggler_min_completed)
        by_id = {w.req.task_id: w for w in cands}
        for tid in ids[:len(idle)]:
            w = by_id[tid]
            w.req.config["_speculated"] = True
            w.req.config["_no_surrogate"] = True
            if tracer is not None:
                tracer.task_speculate(tid, w.attempt + 1, t, w.mark_t)
            broker.push(w.req, w.attempt + 1)

    # per-model cold-init costs: a calibrated/replay spec refines the
    # scalar `server_init` per model; a plain BackendSpec has no hook
    init_for = getattr(spec, "server_init_for", None)

    max_iters = 10_000 + 1_000 * len(reqs)     # runaway-config backstop
    iters = 0
    while n_final < len(reqs):
        iters += 1
        if iters > max_iters:
            raise RuntimeError(
                f"simulate_cluster made no progress after {max_iters} "
                f"events ({n_final}/{len(reqs)} tasks done) — check the "
                f"autoalloc config can actually serve the trace")
        # ---- next event time ------------------------------------------
        extra = stepper.deferred_times()       # backoff release times
        if chaos is not None:
            ct = chaos.next_time()
            if ct is not None:
                extra.append(ct)
        # hedging needs periodic ticks while work is in flight even on a
        # static pool (the straggler check is clock-, not event-, driven)
        elastic = allocator is not None or (
            straggler_factor > 0.0
            and any(w.busy for w in workers.values()))
        nxt = next_event_time(
            arrivals, arr_i,
            (w.end_t for w in workers.values() if w.busy),
            broker, elastic, next_tick, extra)
        if nxt is None:
            break                              # nothing can ever happen
        now = max(now, nxt)
        if now > max_t:
            break
        if now >= next_tick:
            next_tick = now + tick_s

        # ---- arrivals --------------------------------------------------
        while arr_i < len(arrivals) and arrivals[arr_i].t <= now:
            broker.push(reqs[arr_i], 1)
            arr_i += 1

        # ---- completions (before walltime kills: a task ending exactly
        # at expiry did finish) -----------------------------------------
        done = sorted((w for w in workers.values()
                       if w.busy and w.end_t <= now),
                      key=lambda w: (w.end_t, w.wid))
        for w in done:
            if not w.busy:
                continue                       # cancelled earlier this batch
            req = w.req
            if chaos is not None and not req.config.get("_surrogate") \
                    and chaos.take_corruption():
                # corrupted result: the attempt ran to completion but its
                # output is garbage — bill the burned node-seconds and
                # route through retry/quarantine as a fatal failure
                w.alloc.note_busy(max(w.end_t - w.mark_t, 0.0))
                alloc, attempt, mark = w.alloc, w.attempt, w.mark_t
                w.busy, w.req = False, None
                stepper.requeue_or_fail(req, attempt, mark, w.end_t,
                                        alloc, fatal=True)
                continue
            records.append(TaskRecord(
                task_id=req.task_id, submit_t=req.submit_t,
                start_t=w.start_t, end_t=w.end_t,
                cpu_time=w.init + w.compute, compute_t=w.compute,
                worker=f"alloc{w.alloc.alloc_id}-w{w.wid}",
                attempts=w.attempt, status="ok"))
            n_final += 1
            w.alloc.note_busy(w.init + w.compute)
            if tracer is not None:
                tracer.task_attempt(req.task_id, w.alloc.alloc_id, w.wid,
                                    w.mark_t, w.start_t, w.init, w.end_t,
                                    w.attempt, "ok",
                                    model=req.model_name,
                                    compute=w.compute)
            if calibration is not None and \
                    not req.config.get("_surrogate"):
                calibration.observe_attempt(
                    req.model_name, dispatch_s=w.start_t - w.mark_t,
                    init_s=w.init, compute_s=w.compute, now=w.end_t)
            # surrogate completions are milliseconds of GP predict: they
            # must not teach the runtime predictor what the REAL model
            # costs at this theta
            if broker.predictor is not None and \
                    not req.config.get("_surrogate"):
                if registry is not None:
                    # pre-observe residual: |predicted - actual| before
                    # this completion sharpens the predictor
                    pred = broker.predictor.predict(req)
                    if pred is not None:
                        registry.observe("predictor_abs_residual",
                                         abs(pred - w.compute))
                broker.predictor.observe(req, w.compute)
            if not req.config.get("_surrogate"):
                real_done.append((req.model_name, w.compute))
            w.busy, w.req = False, None
            done_ids.add(req.task_id)
            cancel_copies(req.task_id, now)    # hedge losers, if any

        # ---- lifecycle: the shared stepper owns transitions (capped
        # grants), walltime kills, drained-dry, and autoalloc — in the
        # ONE canonical order the live executor also runs ---------------
        stepper.step(now)
        hedge_check(now)

        # ---- dispatch --------------------------------------------------
        for w in dispatch_order():
            if w.busy or w.alloc.state != RUNNING:
                continue
            view = WorkerView(wid=w.wid, warm_models=frozenset(w.warm),
                              budget_left=w.alloc.budget_left(now),
                              alloc_id=w.alloc.alloc_id)
            item = broker.pop(view)
            # a queued copy of a task that already reached a terminal
            # state (quarantined while its hedge ran, etc.) is stale —
            # drop it at pop, exactly as the live executor does
            while item is not None and item[0].task_id in done_ids:
                item = broker.pop(view)
            if item is None:
                continue
            req, attempt = item
            w.req, w.attempt, w.busy = req, attempt, True
            if req.config.get("_surrogate"):
                # offloaded: one GP predict instead of the forward model —
                # no model server, no warm-start bookkeeping.  Count the
                # served evaluation where the live path counts inside
                # evaluate() — same-object stats parity.
                w.compute = getattr(broker.surrogate, "latency_s", 0.05)
                w.init = 0.0
                if hasattr(broker.surrogate, "note_served"):
                    broker.surrogate.note_served()
            else:
                w.compute = runtimes[req.task_id]
                if chaos is not None:
                    w.compute *= chaos.slow_factor(w.wid, now)
                w.init = (0.0 if req.model_name in w.warm
                          else (init_for(req.model_name)
                                if init_for is not None
                                else spec.server_init))
                w.warm.add(req.model_name)
            w.mark_t = now
            w.start_t = now + spec.dispatch_latency
            w.end_t = w.start_t + w.init + w.compute

    # ---- wind down: release held groups; still-queued ones are
    # cancelled (0 node-seconds, as scancel would) -----------------------
    end = max((r.end_t for r in records), default=now)
    stepper.release(end)
    fill_lost(records, reqs, end, tracer)
    alloc_records = sorted((a.record() for a in retired),
                           key=lambda r: r.alloc_id)
    return ClusterResult(
        records=records,
        allocations=alloc_records,
        decisions=list(allocator.decisions) if allocator is not None else [],
        events=list(stepper.events),
        overhead_attribution=(attribute_overhead(tracer.events())
                              if tracer is not None else None))
