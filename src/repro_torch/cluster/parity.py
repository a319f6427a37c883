"""Differential parity harness: one trace, two drivers, one stepper.

The repo's headline numbers are credible only because the simulated
elasticity runs and the live executor exercise the same Broker /
AutoAllocator / LifecycleStepper objects.  This module makes that claim
*testable*: `replay_live` drives the REAL `Executor` machinery — its
broker, allocator, shared `LifecycleStepper`, `_complete`/`_fail`
bookkeeping and allocation records — on a virtual clock with the worker
threads replaced by a deterministic replay loop (the harness plays the
workers: pop, mark running, complete at ``start + init + compute`` in
virtual seconds, using the same `BackendSpec` cost model as the
simulator).  `run_parity` then runs the SAME seeded trace + config
through `simulate_cluster` and `replay_live` and diffs everything the
paper's analysis depends on:

  * per-task terminal status, attempts, and timestamps (including the
    canonical killed-task record shape: ``start_t == end_t``, zero CPU);
  * the allocator decision log (action, allocation id, time, backlog);
  * the stepper's spawn / kill / drain-dry / cancel event sequence;
  * allocation records (group sizes, grant/termination times, billing).

An empty divergence list is the no-forked-logic guarantee on that trace;
`tests/test_parity.py` asserts it across static, elastic, walltime-kill,
drained-dry and surrogate scenarios, and `benchmarks/parity.py --quick`
keeps it honest in CI.

Scope note: the harness replays *lifecycle and scheduling*, not model
execution — completions return placeholder values, so a live run that
conditions a real GP surrogate on completion values has no simulator
counterpart (the sim never produces values).  Parity scenarios involving
offload therefore use deterministic stub engines.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Set

from repro_torch.chaos.inject import ChaosInjector
from repro_torch.cluster.allocation import RUNNING, Allocation
from repro_torch.cluster.autoalloc import AutoAllocConfig, AutoAllocator
from repro_torch.cluster.broker import Broker
from repro_torch.cluster.sim import (ClusterResult, fill_lost, next_event_time,
                               simulate_cluster, trace_requests)
from repro_torch.cluster.traces import TraceTask
from repro_torch.core.backends import BackendSpec
from repro_torch.core.executor import Executor
from repro_torch.core.task import EvalRequest, EvalResult
from repro_torch.sched.policy import WorkerView
from repro_torch.sched.registry import make_predictor


class VirtualClock:
    """Monotonic virtual time: `Executor(clock=...)` reads it, the
    replay loop advances it event by event."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance_to(self, t: float) -> float:
        self.t = max(self.t, float(t))
        return self.t


class _ReplayExecutor(Executor):
    """The real executor, minus thread startup: worker objects exist and
    own their allocations, but the replay loop plays them."""

    _threaded = False


@dataclasses.dataclass
class _Inflight:
    wid: int
    req: EvalRequest
    attempt: int
    mark_t: float        # dispatch decision time (busy-billing base)
    start_t: float       # mark_t + dispatch latency
    end_t: float
    init: float
    compute: float
    wname: str


def replay_live(spec: BackendSpec, trace: List[TraceTask], *,
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
                fault_plan: Any = None,
                retry_policy: Any = None,
                straggler_factor: float = 0.0,
                straggler_min_completed: int = 5) -> ClusterResult:
    """Run one trace through a real `Executor` on a virtual clock.

    Same signature and semantics as `simulate_cluster`; the difference
    is WHICH adapter wraps the shared `LifecycleStepper`: here it is the
    executor's own (`_cluster_step`, thread-table spawn/retire, the
    `_complete`/`_record_expired` result paths), pumped deterministically
    in the simulator's event order — arrivals, completions, lifecycle
    step, dispatch."""
    if broker is None:
        broker = Broker(predictor=make_predictor(predictor), policy=policy)
    if allocator is None and autoalloc is not None:
        if isinstance(autoalloc, AutoAllocator):
            allocator = autoalloc
        else:
            cfg = (autoalloc if isinstance(autoalloc, AutoAllocConfig)
                   else AutoAllocConfig(**autoalloc))
            allocator = AutoAllocator(cfg, spec=spec, seed=seed)

    arrivals, reqs, runtimes = trace_requests(trace, max_attempts,
                                              retry_policy)

    if tracer is not None:
        # the sim emits the identical spec-constants instant (the replay
        # layer reads it back for bit-exact constants); emitting it on
        # both sides keeps the parity span sequences comparable
        tracer.instant("trace.spec", ts=0.0, args={
            "backend": spec.name,
            "dispatch_latency": float(spec.dispatch_latency),
            "server_init": float(spec.server_init),
            "queue_wait_sigma": float(spec.queue_wait_sigma)})

    clock = VirtualClock(0.0)
    factories = {tt.model_name: _never_called for tt in arrivals}
    ex = _ReplayExecutor(
        factories,
        n_workers=(0 if allocator is not None else n_workers),
        max_attempts=max_attempts, max_workers=max_workers,
        allocation_s=walltime_s, cluster=broker, autoalloc=allocator,
        clock=clock, monitor_interval=None,
        straggler_factor=straggler_factor,
        straggler_min_completed=straggler_min_completed,
        tracer=tracer, metrics_registry=registry)
    ex.retry_seed = seed                       # backoff jitter, as the sim
    ex._stepper.retry_seed = seed

    warm: Dict[int, Set[str]] = {}
    inflight: Dict[int, _Inflight] = {}

    # ---- chaos: the injector's handlers mutate the EXECUTOR's tables —
    # the live mirror of the sim's handlers, firing at the same stepper
    # choke point at the same virtual times
    inj: Optional[ChaosInjector] = None
    if fault_plan is not None and len(fault_plan):
        inj = ChaosInjector(fault_plan, tracer=tracer)

        def _crash(ev, t):
            busy = sorted((w for w in ex.workers
                           if w.wid in inflight and w.alloc is not None
                           and not w.alloc.virtual),
                          key=lambda w: (w.alloc.alloc_id, w.wid))
            if not busy:
                return
            w = busy[ev.target % len(busy)]
            e = inflight.pop(w.wid)
            ex._pop_inflight(e.req.task_id, e.attempt)
            w.alloc.note_busy(max(t - e.mark_t, 0.0))
            warm.get(w.wid, set()).clear()     # process restart: cold
            ex._stepper.requeue_or_fail(e.req, e.attempt, e.mark_t, t,
                                        w.alloc, fatal=True)

        def _preempt(ev, t):
            allocs = sorted((a for a in ex.policy.allocations()
                             if not a.virtual and a.state == RUNNING),
                            key=lambda a: a.alloc_id)
            if not allocs:
                return
            victim = allocs[ev.target % len(allocs)]
            deadline = t + ev.duration_s
            if deadline < victim.expiry_t:
                victim.walltime_s = deadline - victim.grant_t
            ex.policy.drain_allocation(victim.alloc_id, t)
            by_wid = {w.wid: w for w in ex.workers}
            for wid in sorted(list(inflight)):
                e = inflight[wid]
                w = by_wid.get(wid)
                if w is None or w.alloc is not victim \
                        or e.end_t <= deadline:
                    continue
                del inflight[wid]
                ex._pop_inflight(e.req.task_id, e.attempt)
                victim.note_busy(max(t - e.mark_t, 0.0))
                ex._stepper.requeue_or_fail(e.req, e.attempt, e.mark_t,
                                            t, victim, migrate=True)

        def _slow(ev, t):
            cand = sorted((w for w in ex.workers
                           if w.alloc is not None and not w.alloc.virtual
                           and w.alloc.state == RUNNING),
                          key=lambda w: (w.alloc.alloc_id, w.wid))
            if cand:
                w = cand[ev.target % len(cand)]
                inj.set_slow(w.wid, ev.factor, t + ev.duration_s)

        def _outage(ev, t):
            sur = getattr(ex.policy, "surrogate", None)
            if sur is not None and hasattr(sur, "set_degraded"):
                sur.set_degraded(t, t + ev.duration_s, "outage")

        inj.on("worker_crash", _crash)
        inj.on("preempt", _preempt)
        inj.on("slow_node", _slow)
        inj.on("surrogate_outage", _outage)
        # journal_torn: the replay has no journal — symmetric no-op
        ex._stepper.chaos = inj

    def _slot_alive(e):
        ent = ex._running.get(e.req.task_id)
        if ent is not None and ent[3] == e.attempt:
            return True
        ent = ex._hedges.get(e.req.task_id)
        return ent is not None and ent[3] == e.attempt

    _TERMINAL = ("ok", "failed", "timeout", "quarantined")

    def n_terminal():
        return sum(1 for r in ex._results.values()
                   if r.status in _TERMINAL)

    arr_i = 0
    now = 0.0
    next_tick = 0.0
    n_final = 0                                # tasks with a terminal result

    max_iters = 10_000 + 1_000 * len(reqs)
    iters = 0
    while n_final < len(reqs):
        iters += 1
        if iters > max_iters:
            raise RuntimeError(
                f"replay_live made no progress after {max_iters} events "
                f"({n_final}/{len(reqs)} tasks done)")
        # ---- next event time (the sim's candidate set, shared code) ---
        extra = ex._stepper.deferred_times()   # backoff release times
        if inj is not None:
            ct = inj.next_time()
            if ct is not None:
                extra.append(ct)
        elastic = allocator is not None or (
            straggler_factor > 0.0 and bool(inflight))
        nxt = next_event_time(arrivals, arr_i,
                              (e.end_t for e in inflight.values()),
                              broker, elastic, next_tick, extra)
        if nxt is None:
            break
        now = max(now, nxt)
        if now > max_t:
            break
        clock.advance_to(now)
        if now >= next_tick:
            next_tick = now + tick_s

        # ---- arrivals --------------------------------------------------
        while arr_i < len(arrivals) and arrivals[arr_i].t <= now:
            ex.submit(reqs[arr_i])             # stamps submit_t = clock()
            arr_i += 1

        # ---- completions (before walltime kills, as in the sim) -------
        done = sorted((e for e in inflight.values() if e.end_t <= now),
                      key=lambda e: (e.end_t, e.wid))
        for e in done:
            if not _slot_alive(e):
                del inflight[e.wid]            # cancelled this batch
                continue
            if inj is not None and not e.req.config.get("_surrogate") \
                    and inj.take_corruption():
                # corrupted result (sim mirror): bill the burned work,
                # route through retry/quarantine as a fatal failure
                ent = ex._pop_inflight(e.req.task_id, e.attempt)
                w = ent[1] if ent is not None else None
                alloc = w.alloc if w is not None else None
                if alloc is not None:
                    alloc.note_busy(max(e.end_t - e.mark_t, 0.0))
                ex._stepper.requeue_or_fail(e.req, e.attempt, e.mark_t,
                                            e.end_t, alloc, fatal=True)
                del inflight[e.wid]
                continue
            ex._complete(e.req, EvalResult(
                task_id=e.req.task_id, value=[[0.0]], status="ok",
                worker=e.wname, attempts=e.attempt,
                submit_t=e.req.submit_t, dispatch_t=e.mark_t,
                start_t=e.start_t, end_t=e.end_t,
                compute_t=e.compute, init_t=e.init))
            del inflight[e.wid]

        # ---- lifecycle: the executor's own stepper adapter ------------
        ex._cluster_step()
        # workers the stepper (or a chaos handler, or a lost hedge race)
        # tore down took their in-flight tasks with them: drop the stale
        # slots; terminal accounting is recomputed below
        for wid in [wid for wid, e in inflight.items()
                    if not _slot_alive(e)]:
            del inflight[wid]

        # ---- speculative re-execution (the executor's own check, the
        # same shared ladder + capacity gate the sim runs) --------------
        if straggler_factor > 0.0:
            ex._straggler_check(now)
        n_final = n_terminal()

        # ---- dispatch (sim order: by allocation, then worker id) ------
        for w in sorted(ex.workers, key=lambda w: (w.alloc.alloc_id,
                                                   w.wid)):
            if w.wid in inflight or w.alloc.state != RUNNING:
                continue
            mine = warm.setdefault(w.wid, set())
            view = WorkerView(wid=w.wid, warm_models=frozenset(mine),
                              budget_left=w.alloc.budget_left(now),
                              alloc_id=w.alloc.alloc_id)
            with ex._cv:
                item = ex.policy.pop(view)
                while item is not None and \
                        ex._already_done(item[0].task_id):
                    item = ex.policy.pop(view)   # as Worker.run drops them
            if item is None:
                continue
            req, attempt = item
            ex._mark_running(req, w, attempt)
            if req.config.get("_surrogate"):
                compute = float(getattr(broker.surrogate, "latency_s",
                                        0.05))
                init = 0.0
                if hasattr(broker.surrogate, "note_served"):
                    broker.surrogate.note_served()
                wname = f"{w.name}-surrogate"
            else:
                compute = runtimes[req.task_id]
                if inj is not None:
                    compute *= inj.slow_factor(w.wid, now)
                init = 0.0 if req.model_name in mine else spec.server_init
                mine.add(req.model_name)
                wname = w.name
            start = now + spec.dispatch_latency
            inflight[w.wid] = _Inflight(
                wid=w.wid, req=req, attempt=attempt, mark_t=now,
                start_t=start, end_t=start + init + compute,
                init=init, compute=compute, wname=wname)

    # ---- wind down (mirrors the sim's) --------------------------------
    end = max((r.end_t for r in ex._results.values()), default=now)
    with ex._cv:
        ex._stepper.release(end)
    records = ex.records()
    fill_lost(records, reqs, end, tracer)
    alloc_records = sorted((a.record() for a in ex._retired_allocs),
                           key=lambda r: r.alloc_id)
    decisions = (list(allocator.decisions) if allocator is not None
                 else [])
    events = list(ex._stepper.events)
    ex.shutdown()
    attribution = None
    if tracer is not None:
        from repro_torch.obs.attribution import attribute_overhead
        attribution = attribute_overhead(tracer.events())
    return ClusterResult(records=records, allocations=alloc_records,
                         decisions=decisions, events=events,
                         overhead_attribution=attribution)


def _never_called():
    raise AssertionError("replay_live plays the workers itself: no model "
                         "server is ever instantiated")


# ---------------------------------------------------------------------------
# the differential check
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ParityReport:
    sim: ClusterResult
    live: ClusterResult
    divergences: List[str]

    @property
    def ok(self) -> bool:
        return not self.divergences


def _close(a: float, b: float, tol: float) -> bool:
    if math.isnan(a) and math.isnan(b):
        return True
    return math.isclose(a, b, rel_tol=tol, abs_tol=tol)


def compare_results(sim: ClusterResult, live: ClusterResult,
                    tol: float = 1e-9) -> List[str]:
    """Diff two `ClusterResult`s on everything that must agree.  Worker
    name strings are the drivers' own (thread names vs sim labels) and
    are deliberately not compared — except for terminal 'failed' records,
    whose canonical shape pins the worker to ``alloc<id>``."""
    out: List[str] = []

    sim_by = {r.task_id: r for r in sim.records}
    live_by = {r.task_id: r for r in live.records}
    if set(sim_by) != set(live_by):
        out.append(f"task sets differ: sim-only="
                   f"{sorted(set(sim_by) - set(live_by))}, live-only="
                   f"{sorted(set(live_by) - set(sim_by))}")
    for tid in sorted(set(sim_by) & set(live_by)):
        s, l = sim_by[tid], live_by[tid]
        if s.status != l.status or s.attempts != l.attempts:
            out.append(f"{tid}: status/attempts sim=({s.status},"
                       f"{s.attempts}) live=({l.status},{l.attempts})")
            continue
        for f in ("submit_t", "start_t", "end_t", "cpu_time", "compute_t"):
            if not _close(getattr(s, f), getattr(l, f), tol):
                out.append(f"{tid}: {f} sim={getattr(s, f)} "
                           f"live={getattr(l, f)}")
        if s.status in ("failed", "quarantined"):
            for r, side in ((s, "sim"), (l, "live")):
                if r.start_t != r.end_t or r.cpu_time != 0.0 \
                        or not r.worker.startswith("alloc"):
                    out.append(f"{tid}: non-canonical killed record "
                               f"({side}): {r}")

    if [e[1:] for e in sim.events] != [e[1:] for e in live.events] or \
            not all(_close(a[0], b[0], tol)
                    for a, b in zip(sim.events, live.events)):
        out.append(f"stepper events differ:\n  sim ={sim.events}\n"
                   f"  live={live.events}")

    if len(sim.decisions) != len(live.decisions):
        out.append(f"decision counts differ: sim={len(sim.decisions)} "
                   f"live={len(live.decisions)}")
    else:
        for i, (ds, dl) in enumerate(zip(sim.decisions, live.decisions)):
            if ds["action"] != dl["action"] \
                    or ds["alloc_id"] != dl["alloc_id"] \
                    or not _close(ds["t"], dl["t"], tol) \
                    or not _close(ds["backlog_per_worker_s"],
                                  dl["backlog_per_worker_s"], tol):
                out.append(f"decision {i} differs: sim={ds} live={dl}")

    sim_allocs = {a.alloc_id: a for a in sim.allocations}
    live_allocs = {a.alloc_id: a for a in live.allocations}
    if set(sim_allocs) != set(live_allocs):
        out.append(f"allocation id sets differ: sim={sorted(sim_allocs)} "
                   f"live={sorted(live_allocs)}")
    for aid in sorted(set(sim_allocs) & set(live_allocs)):
        s, l = sim_allocs[aid], live_allocs[aid]
        if s.n_workers != l.n_workers or s.state != l.state:
            out.append(f"alloc {aid}: shape sim=({s.n_workers},{s.state}) "
                       f"live=({l.n_workers},{l.state})")
        for f in ("submit_t", "start_t", "end_t", "queue_wait", "busy_t"):
            if not _close(getattr(s, f), getattr(l, f), tol):
                out.append(f"alloc {aid}: {f} sim={getattr(s, f)} "
                           f"live={getattr(l, f)}")
        if not _close(s.node_seconds, l.node_seconds, tol):
            out.append(f"alloc {aid}: node_seconds sim={s.node_seconds} "
                       f"live={l.node_seconds}")
    return out


def run_parity(spec: BackendSpec, trace: List[TraceTask], *,
               policy: Any = "fcfs",
               autoalloc: Optional[AutoAllocConfig] = None,
               n_workers: int = 4,
               walltime_s: Optional[float] = None,
               max_workers: Optional[int] = None,
               seed: int = 0, tick_s: float = 5.0,
               max_attempts: int = 3,
               surrogate_factory: Any = None,
               fault_plan: Any = None,
               retry_policy: Any = None,
               straggler_factor: float = 0.0,
               straggler_min_completed: int = 5,
               tol: float = 1e-9,
               tracers: Optional[tuple] = None) -> ParityReport:
    """One differential run: same trace, same config, both drivers.

    Fresh-but-identical Broker/AutoAllocator instances are built per
    side (the objects are stateful, so they cannot literally be shared
    across two runs); in static mode the sim broker is seeded with a
    zero-queue-wait allocation matching the executor's initial group.

    ``tracers=(sim_tracer, live_tracer)`` attaches one `repro_torch.obs.Tracer`
    per driver; both run on the virtual clock, so
    `span_sequence(sim_tracer) == span_sequence(live_tracer)` on a
    parity-clean trace — the observability layer inherits the
    no-forked-logic guarantee.
    """
    def make_broker():
        b = Broker(policy=policy)
        if surrogate_factory is not None:
            b.attach_surrogate(surrogate_factory())
        return b

    def make_allocator():
        if autoalloc is None:
            return None
        return AutoAllocator(autoalloc, spec=spec, seed=seed)

    kw = dict(seed=seed, tick_s=tick_s, max_attempts=max_attempts,
              max_workers=max_workers, walltime_s=walltime_s,
              n_workers=n_workers, fault_plan=fault_plan,
              retry_policy=retry_policy, straggler_factor=straggler_factor,
              straggler_min_completed=straggler_min_completed)
    sim_tracer, live_tracer = tracers if tracers is not None else (None,
                                                                   None)
    sim_broker = make_broker()
    if autoalloc is None:
        # match the live executor's initial group: granted at t=0 with
        # zero queue wait (thread startup, not a SLURM queue)
        init = Allocation(sim_broker.next_alloc_id(), n_workers,
                          walltime_s)
        init.submit(0.0, 0.0)
        sim_broker.add_allocation(init)
    sim = simulate_cluster(spec, trace, broker=sim_broker,
                           allocator=make_allocator(), tracer=sim_tracer,
                           **kw)
    live = replay_live(spec, trace, broker=make_broker(),
                       allocator=make_allocator(), tracer=live_tracer,
                       **kw)
    return ParityReport(sim=sim, live=live,
                        divergences=compare_results(sim, live, tol))
