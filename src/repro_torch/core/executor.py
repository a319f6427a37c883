"""Live execution engine: persistent-worker task scheduling over real JAX.

This realises the paper's mechanism with *real* costs instead of simulated
ones: a pool of persistent workers (threads; on a TPU pod, one per mesh
slice) pulls evaluation requests from a pluggable `repro_torch.sched` scheduling
policy (FCFS by default; SJF/LPT/cost-aware packing/work stealing by
name), with an optional online runtime predictor learning task costs from
completions.

  * HQ semantics (`persistent_servers=True`): each worker instantiates a
    model server ONCE and reuses it — the jit-compile / warmup cost (the
    real analogue of the paper's ~1 s model-server init + SLURM env
    re-init) is paid once per (worker, model).
  * naive-SLURM semantics (`persistent_servers=False`): every task gets a
    fresh model server — re-init/re-compile every time, which is exactly
    why the naive backend loses on anything short.

Production features beyond the paper's prototype:
  * fault tolerance: worker death or task exception -> requeue up to
    `max_attempts`; queue state snapshot/restore (checkpoint-restart);
  * straggler mitigation: speculative re-issue of tasks running longer
    than `straggler_factor` x the p95 of completed runtimes, first result
    wins (generalising HQ's time-request/time-limit split);
  * elastic scaling: `scale_to(n)` while running; worker groups are
    allocation-backed (`repro_torch.cluster`) — an optional `AutoAllocator`
    submits and drains whole allocations from backlog *cost* (seconds of
    queued work), reproducing HQ's autoalloc; the legacy count-based
    `autoscale_backlog` kwarg is an alias routed through the same
    allocator;
  * dependent tasks: requests with `depends_on` wait until their
    predecessors complete (MCMC-style chains, adaptive GP loops);
  * time limits: tasks observed to exceed `time_limit` are marked
    "timeout" (the limit bounds runaway jobs; the *time_request* hint is
    used only for dispatch ordering when `pack_by_cost=True`).
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.chaos.speculate import find_stragglers
from repro_torch.core.metrics import TaskRecord
from repro_torch.core.task import EvalRequest, EvalResult, Model
from repro_torch.sched import make_policy, make_predictor
from repro_torch.sched.policy import SchedulingPolicy, WorkerView

_STOP = object()


class _Server:
    """One instantiated model server on one worker.  `init_t` is the cost
    of the FIRST instantiation and is never overwritten — warm reuses
    report 0 per dispatch while the warmup-cost record survives."""

    def __init__(self, model: Model, init_t: float):
        self.model = model
        self.init_t = init_t
        self.n_evals = 0


class Worker(threading.Thread):
    def __init__(self, pool: "Executor", wid: int, alloc=None):
        super().__init__(name=f"worker-{wid}", daemon=True)
        self.pool = pool
        self.wid = wid
        self.alloc = alloc                     # owning repro_torch.cluster Allocation
        self.alive = True
        self.servers: Dict[str, _Server] = {}
        self.crashed = False

    def view(self) -> WorkerView:
        """What the scheduling policy may know about this worker.  Every
        worker belongs to an `Allocation`; the budget is that group's
        remaining walltime (None when unbounded — budget-aware packing
        then degrades to plain LPT order, as documented)."""
        budget = alloc_id = None
        if self.alloc is not None:
            budget = self.alloc.budget_left(self.pool._clock())
            alloc_id = self.alloc.alloc_id
        return WorkerView(wid=self.wid, warm_models=frozenset(self.servers),
                          budget_left=budget, alloc_id=alloc_id)

    def _get_server(self, name: str) -> Tuple[_Server, float]:
        """Return (server, init seconds paid by THIS dispatch: 0 on reuse)."""
        if self.pool.persistent_servers and name in self.servers:
            return self.servers[name], 0.0
        t0 = self.pool._clock()
        model = self.pool.model_factories[name]()
        model.warmup()
        init_t = self.pool._clock() - t0
        server = _Server(model, init_t)
        self.pool._note_server_init(init_t)
        if self.pool.persistent_servers:
            self.servers[name] = server
        return server, init_t

    def run(self):
        while self.alive:
            try:
                item = self.pool._queue_get(timeout=0.02, worker=self)
            except IndexError:
                continue
            if item is _STOP:
                break
            if item is None:
                continue                       # a stale copy, dropped
            req, attempt = item
            dispatch_t = self.pool._clock()
            surrogate = (self.pool._surrogate()
                         if req.config.get("_surrogate") else None)
            surrogate_failed = False
            try:
                if self.crashed:
                    raise RuntimeError(f"worker-{self.wid} crashed")
                fail_n = int(req.config.get("fail_attempts", 0))
                if attempt <= fail_n:
                    raise RuntimeError("injected failure")
                if surrogate is not None:
                    # offload path: one GP predict, no model server
                    t0 = self.pool._clock()
                    try:
                        value = surrogate.evaluate(req.parameters)
                    except Exception:
                        surrogate_failed = True
                        raise
                    compute_t = self.pool._clock() - t0
                    init_t = 0.0
                    wname = f"{self.name}-surrogate"
                else:
                    server, init_t = self._get_server(req.model_name)
                    try:
                        t0 = self.pool._clock()
                        value = server.model(req.parameters, req.config)
                        compute_t = self.pool._clock() - t0
                        server.n_evals += 1
                    finally:
                        # Port change: a fresh server is dropped with its
                        # request, failed or not, before the next one is
                        # built, so that two never hold the device at once
                        # (the reference keeps it until the next dispatch
                        # returns).
                        server = None
                    wname = self.name
                status = "ok"
                if req.time_limit and compute_t > req.time_limit:
                    status = "timeout"
                res = EvalResult(
                    task_id=req.task_id, value=value, status=status,
                    worker=wname, attempts=attempt,
                    submit_t=req.submit_t, dispatch_t=dispatch_t,
                    start_t=dispatch_t, end_t=self.pool._clock(),
                    compute_t=compute_t, init_t=init_t)
                self.pool._complete(req, res)
            except Exception as e:  # noqa: BLE001 — any task failure requeues
                if surrogate_failed:
                    # a broken SURROGATE must not fail the task: PIN the
                    # retry to the real path (just dropping the flag is
                    # not enough — the requeue re-decides and would
                    # re-route to the same broken surrogate) and refund
                    # the "CPU seconds avoided" credit.  Failures raised
                    # before evaluate() (worker crash, injected failure)
                    # are NOT the surrogate's fault: the retry may still
                    # take the offload the gates approved.
                    req.config.pop("_surrogate", None)
                    req.config["_no_surrogate"] = True
                    surrogate.rollback(req)
                self.pool._fail(req, attempt, repr(e), self)
                if self.crashed:
                    self.alive = False
                    self.pool._on_worker_death(self)


class Executor:
    """Persistent-worker executor with pluggable scheduling, fault
    tolerance and elastic scaling.

    `policy` selects how queued tasks are ordered/routed (a registered
    name — "fcfs", "sjf", "lpt", "pack", "steal" — or a configured
    `SchedulingPolicy` instance); `predictor` supplies online per-task
    cost estimates ("quantile", "gp", or a `RuntimePredictor`).  Every
    successful completion is fed back to the predictor, so cost-aware
    policies sharpen as the run progresses.  The legacy `pack_by_cost`
    flag maps onto `policy="sjf"` (ordering by the static time request,
    exactly the old inline-heap behaviour).

    Worker groups are allocation-backed (`repro_torch.cluster.Allocation`):
    `allocation_s` bounds the initial group's walltime (workers then
    advertise their remaining budget to the policy, which is what makes
    `policy="pack"` allocation-aware here).  `cluster=` accepts a
    configured `Broker` (one policy per allocation, cluster-level
    routing) and `autoalloc=` an `AutoAllocConfig` / `AutoAllocator`
    that submits and drains allocations from backlog cost — the same
    objects `simulate_cluster` drives on a virtual clock.  The legacy
    count-based `autoscale_backlog` is an alias routed through that
    allocator (one single-worker allocation per step, and idle groups
    can now be drained — the old loop could only grow).

    In cluster mode the allocation lifecycle is driven by the shared
    `repro_torch.cluster.stepper.LifecycleStepper` — the same rules (and rule
    ORDER) `simulate_cluster` runs on a virtual clock; `_cluster_step`
    is just the monitor-thread adapter around one `stepper.step()`.
    `clock` injects the time source (default `time.monotonic`) and
    `monitor_interval=None` disables the monitor thread — together they
    let the differential parity harness (`repro_torch.cluster.parity`) drive
    this executor deterministically on a virtual clock via `step()`.
    """

    def __init__(self, model_factories: Dict[str, Callable[[], Model]],
                 n_workers: int = 2, *, persistent_servers: bool = True,
                 max_attempts: int = 3, backlog_limit: Optional[int] = None,
                 pack_by_cost: bool = False,
                 policy: Any = "fcfs",
                 predictor: Any = None,
                 straggler_factor: float = 0.0,
                 straggler_min_completed: int = 5,
                 autoscale_backlog: Optional[int] = None,
                 max_workers: Optional[int] = 32,
                 allocation_s: Optional[float] = None,
                 cluster: Any = None,
                 autoalloc: Any = None,
                 clock: Optional[Callable[[], float]] = None,
                 monitor_interval: Optional[float] = 0.05,
                 tracer: Any = None,
                 metrics_registry: Any = None,
                 calibration: Any = None,
                 on_result: Optional[Callable[[EvalRequest, EvalResult],
                                              None]] = None,
                 on_tick: Optional[Callable[[float], None]] = None,
                 name: str = "hq"):
        from repro_torch.cluster.allocation import Allocation
        from repro_torch.cluster.autoalloc import AutoAllocConfig, AutoAllocator
        from repro_torch.cluster.broker import Broker
        from repro_torch.cluster.stepper import LifecycleStepper
        self._clock = clock if clock is not None else time.monotonic
        # opt-in observability (repro_torch.obs): spans/instants stamped with
        # THIS executor's injected clock, so virtual-clock replays
        # produce traces comparable with the simulator's
        self.tracer = tracer
        self.registry = metrics_registry
        # optional repro_torch.obs.calib.CalibrationMonitor: fed the observed
        # per-attempt overheads (and, in cluster mode, granted queue
        # waits via the stepper) so model-vs-reality drift raises alarms
        # while the run is live
        self.calibration = calibration
        if tracer is not None:
            tracer.bind_clock(self._clock)
        self.model_factories = dict(model_factories)
        self.persistent_servers = persistent_servers
        self.max_attempts = max_attempts
        self.backlog_limit = backlog_limit
        self.pack_by_cost = pack_by_cost
        self.straggler_factor = straggler_factor
        self.straggler_min_completed = straggler_min_completed
        self.autoscale_backlog = autoscale_backlog
        self.max_workers = max_workers
        self.name = name
        # terminal-result hook (repro_torch.service billing/SLO accounting):
        # fired once per stored result, UNDER the dispatch lock — must be
        # O(1) and must never call back into this executor
        self.on_result = on_result

        if pack_by_cost and policy in (None, "fcfs"):
            policy = "sjf"
        pred = make_predictor(predictor)
        wants_cluster = (cluster is not None or autoalloc is not None
                         or autoscale_backlog is not None)
        if cluster is not None:
            if not isinstance(cluster, Broker):
                raise TypeError(f"cluster= expects a Broker, got {cluster!r}")
            self.policy: SchedulingPolicy = cluster.bind(pred)
        elif wants_cluster and not isinstance(policy, Broker):
            if isinstance(policy, SchedulingPolicy):
                raise TypeError(
                    "autoalloc/autoscale need one policy instance PER "
                    "allocation: pass the policy by registered name (or a "
                    "Broker via cluster=), not a shared instance")
            # policy="broker" here means "use brokered dispatch", not
            # "nest a broker per allocation" — map it to the default
            self.policy = Broker(predictor=pred,
                                 policy="fcfs" if policy == "broker"
                                 else policy)
        else:
            self.policy = make_policy(policy, pred)
        # completions feed the predictor the policy actually READS — if a
        # policy instance arrived with its own, that binding wins and any
        # `predictor=` kwarg is superseded (no split-brain feedback loop)
        self.predictor = self.policy.predictor
        self.allocation_s = allocation_s
        self._cluster_mode = isinstance(self.policy, Broker)
        if tracer is not None:
            if self._cluster_mode:
                # BEFORE the initial allocation registers, so its whole
                # lifecycle is on the trace
                self.policy.set_tracer(tracer)
            else:
                sur = self._surrogate()
                if sur is not None:
                    sur.tracer = tracer

        if autoalloc is not None:
            self.autoalloc = (autoalloc if isinstance(autoalloc,
                                                      AutoAllocator)
                              else AutoAllocator(
                                  autoalloc if isinstance(autoalloc,
                                                          AutoAllocConfig)
                                  else AutoAllocConfig(**autoalloc)))
        elif autoscale_backlog is not None:
            # deprecated count-based path, now an alias reproducing the
            # old ABSOLUTE "backlog() > N tasks" trigger exactly:
            # count_tasks ignores cost hints, per_worker=False skips the
            # capacity division the legacy loop never did; served by
            # single-worker allocations up to max_workers
            cap = max_workers if max_workers is not None else 32
            self.autoalloc = AutoAllocator(AutoAllocConfig(
                workers_per_alloc=1, walltime_s=None,
                backlog_high_s=float(autoscale_backlog),
                backlog_low_s=1.0, per_worker=False, count_tasks=True,
                max_pending=cap,
                max_allocations=max(cap - n_workers + 1, 1),
                min_allocations=1, idle_drain_s=30.0, hysteresis_s=0.05))
        else:
            self.autoalloc = None
        if self.autoalloc is not None and max_workers is not None:
            # the allocator must see the pool cap or it churns grants the
            # monitor can only cancel (zero-headroom submit loops).  An
            # uncapped pool (max_workers=None) preserves any caller-set
            # worker_cap — exactly as `simulate_cluster` does, so a
            # shared allocator instance behaves identically on both paths
            self.autoalloc.worker_cap = max_workers

        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._waiting: List[Tuple[EvalRequest, int]] = []   # unmet deps
        # task_id -> (request, worker, start time, attempt number)
        self._running: Dict[str, Tuple[EvalRequest, Worker, float, int]] = {}
        # second in-flight copy of a speculatively re-executed task
        # (first completion wins; the loser is cancelled and billed)
        self._hedges: Dict[str, Tuple[EvalRequest, Worker, float, int]] = {}
        # worker-killing failures per task (quarantine threshold), for
        # the threaded path; the replay/sim path counts in the stepper
        self._fail_counts: Dict[str, int] = {}
        self.retry_seed = 0                    # backoff-jitter seed
        self._results: Dict[str, EvalResult] = {}
        self._requests: Dict[str, EvalRequest] = {}
        self._init_total_t = 0.0               # cumulative server-init cost
        self._init_count = 0
        self._t0 = self._clock()
        self.workers: List[Worker] = []
        self._retired_allocs: List[Any] = []   # for allocation_records()
        self._stopping = False
        # the shared lifecycle state machine (cluster mode): exactly the
        # rules, in exactly the order, `simulate_cluster` runs
        self._stepper = None
        if self._cluster_mode:
            self._stepper = LifecycleStepper(
                self.policy, self.autoalloc, now=self._clock,
                spawn_workers=self._spawn_group,
                retire_workers=self._retire_group,
                busy_count=self._busy_by_alloc,
                worker_count=self._n_real_workers,
                record_failed=self._record_expired,
                record_quarantined=self._record_quarantined,
                max_workers=max_workers, max_attempts=max_attempts,
                retired=self._retired_allocs,
                tracer=tracer, registry=metrics_registry,
                calibration=calibration, on_tick=on_tick)
        # the initial worker group: one allocation, granted immediately
        # (thread startup is the live analogue of the queue wait).  In
        # cluster mode n_workers=0 means "bootstrap from the allocator"
        # — zero standing capacity, exactly like the elastic simulator —
        # and the group is granted THROUGH the stepper, so even the
        # initial spawn takes the canonical capped QUEUED->RUNNING path.
        self._initial_alloc = None
        if not self._cluster_mode or n_workers > 0:
            alloc_id = (self.policy.next_alloc_id() if self._cluster_mode
                        else 0)
            self._initial_alloc = Allocation(alloc_id, n_workers,
                                             allocation_s)
            self._initial_alloc.submit(self._t0, 0.0)
            if self._cluster_mode:
                self.policy.add_allocation(self._initial_alloc)
            else:
                self._initial_alloc.tick(self._t0)
                if tracer is not None:
                    tracer.alloc_state(self._initial_alloc)
                for i in range(n_workers):
                    self._add_worker(self._initial_alloc)
        if self._cluster_mode:
            self._cluster_step()               # grant + spawn at t0
        self._monitor = None
        if monitor_interval is not None and monitor_interval > 0:
            self._monitor_interval = monitor_interval
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True)
            self._monitor.start()

    # ------------------------------------------------------------------
    # queue plumbing
    # ------------------------------------------------------------------
    def _queue_get(self, timeout: float, worker: Optional[Worker] = None):
        """Pop the next (request, attempt) for `worker`.  With a worker,
        the pop, the drop of a stale copy of a finished task (returned as
        None) and the running mark are one critical section.  (The
        reference pops here and marks in `Worker.run`, each under its own
        acquisition of the lock: a `snapshot()` between the two finds the
        task neither queued nor running, and a service journal written
        then loses it — `ServiceBroker.recover` waits for it forever.)"""
        view = worker.view() if worker is not None else None
        with self._cv:
            if not len(self.policy):
                self._cv.wait(timeout)
            item = self.policy.pop(view)
            if item is None:
                raise IndexError
            if worker is not None:
                if self._already_done(item[0].task_id):
                    return None
                self._mark_running(item[0], worker, item[1])
            return item

    def _push(self, req: EvalRequest, attempt: int):
        with self._cv:
            if self.tracer is not None and not self._cluster_mode:
                # cluster mode: the Broker's own push emits this
                self.tracer.task_queued(req.task_id, attempt, req=req)
            self.policy.push(req, attempt)
            self._cv.notify()

    def _already_done(self, task_id: str) -> bool:
        """Terminal states whose stale queued copies must be dropped at
        pop: a quarantined or terminally failed task can still have a
        hedge or requeued copy sitting in the queue."""
        with self._lock:
            return task_id in self._results and \
                self._results[task_id].status in ("ok", "failed",
                                                  "quarantined")

    def _mark_running(self, req: EvalRequest, worker: Worker, attempt: int):
        with self._lock:
            entry = (req, worker, self._clock(), attempt)
            if req.task_id in self._running:
                # a second copy of a hedged task: first completion wins
                self._hedges[req.task_id] = entry
            else:
                self._running[req.task_id] = entry

    def _note_server_init(self, init_t: float):
        with self._lock:
            self._init_total_t += init_t
            self._init_count += 1

    def _surrogate(self):
        """The surrogate-offload engine, when the policy carries one
        (`SurrogateOffloadPolicy` or a `Broker` with ``surrogate=``)."""
        return getattr(self.policy, "surrogate", None)

    def _complete(self, req: EvalRequest, res: EvalResult):
        # derived from the RESULT, not req.config: the shared config is
        # re-stamped by every re-push decision (speculation, requeues)
        # and may have changed while this attempt was in flight
        offloaded = res.worker.endswith("-surrogate")
        if res.status == "ok" and not offloaded:
            # outside the scheduler lock: a GP refit must not stall
            # dispatch.  Offloaded completions are skipped: milliseconds
            # of GP predict must not teach the runtime predictor what the
            # REAL model costs at this theta.
            if self.predictor is not None:
                if self.registry is not None:
                    # residual BEFORE observe: the prediction this run's
                    # dispatch actually used, not the sharpened one
                    try:
                        pred = self.predictor.predict(req)
                        if pred is not None:
                            self.registry.observe(
                                "predictor_abs_residual",
                                abs(pred - res.compute_t))
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
                try:
                    self.predictor.observe(req, res.compute_t)
                except Exception:  # noqa: BLE001 — prediction is best-effort
                    pass
            sur = self._surrogate()
            if sur is not None:
                # a real run is ground truth for the QoI surrogate too:
                # conditioning on it widens the trusted region
                try:
                    sur.observe(req.parameters, res.value,
                                model_name=req.model_name)
                except Exception:  # noqa: BLE001 — enrichment is best-effort
                    pass
        with self._cv:
            # the completing ATTEMPT picks its own slot: a hedged task
            # has two in-flight copies keyed by the same task_id, and
            # billing/teardown must hit the copy that actually finished
            entry = self._running.get(req.task_id)
            hedge = self._hedges.get(req.task_id)
            if hedge is not None and hedge[3] == res.attempts and \
                    (entry is None or entry[3] != res.attempts):
                entry = self._hedges.pop(req.task_id)
            elif entry is not None:
                self._running.pop(req.task_id)
            # busy billing happens HERE, under the lock, keyed on still
            # being in flight: a task whose allocation expired was
            # already billed (partial, up to the kill) by the stepper and
            # removed by _retire_group, so no double count is possible
            if entry is not None:
                w = entry[1]
                if w is not None and w.alloc is not None \
                        and w.alloc.state != "expired":
                    w.alloc.note_busy(res.cpu_time)
            prev = self._results.get(req.task_id)
            # first success wins; "failed"/"quarantined" are TERMINAL
            # (recorded only once every attempt is spent — e.g. an
            # allocation-expiry kill at max_attempts, after which the
            # orphaned thread may still finish; matching
            # simulate_cluster, its late result is void)
            if prev is None or prev.status not in ("ok", "failed",
                                                   "quarantined"):
                self._results[req.task_id] = res
                # first-completion-wins: any OTHER copy of this task
                # still in flight lost the race — cancel it, billing the
                # partial work where it ran
                self._cancel_copies(req.task_id)
                if self.tracer is not None and entry is not None:
                    w = entry[1]
                    aid = (w.alloc.alloc_id if w.alloc is not None else 0)
                    self.tracer.task_attempt(
                        req.task_id, aid, w.wid, res.dispatch_t,
                        res.start_t, res.init_t, res.end_t,
                        res.attempts, res.status,
                        model=req.model_name, compute=res.compute_t)
                if self.calibration is not None and entry is not None \
                        and not offloaded:
                    self.calibration.observe_attempt(
                        req.model_name,
                        dispatch_s=res.start_t - res.dispatch_t,
                        init_s=res.init_t, compute_s=res.compute_t,
                        now=res.end_t)
                self._notify_result(req, res)
            self._release_dependents()
            self._cv.notify_all()

    def _cancel_copies(self, task_id: str, t: Optional[float] = None):
        """A task just reached a terminal state: cancel any other
        in-flight copy (the loser of a speculative hedge, or a copy
        orphaned by quarantine), billing its partial work where it ran.
        Runs under the dispatch lock."""
        if t is None:
            t = self._clock()
        for table in (self._running, self._hedges):
            other = table.pop(task_id, None)
            if other is None:
                continue
            _oreq, ow, ot, oattempt = other
            if ow is not None and ow.alloc is not None \
                    and ow.alloc.state != "expired":
                ow.alloc.note_busy(max(t - ot, 0.0))
            if self.tracer is not None:
                self.tracer.task_hedge_cancel(task_id, oattempt, t, ot)

    def _pop_inflight(self, task_id: str, attempt: int):
        """Remove (and return) the in-flight entry for one specific
        attempt of a task, whichever table it landed in."""
        entry = self._running.get(task_id)
        if entry is not None and entry[3] == attempt:
            return self._running.pop(task_id)
        hedge = self._hedges.get(task_id)
        if hedge is not None and hedge[3] == attempt:
            return self._hedges.pop(task_id)
        return self._running.pop(task_id, None)

    def _fail(self, req: EvalRequest, attempt: int, error: str,
              worker: Worker):
        with self._cv:
            entry = self._pop_inflight(req.task_id, attempt)
            if self._already_done(req.task_id):
                return
            # hardened recovery (threaded path; the replay/sim path runs
            # the same rules through the shared stepper): worker-killing
            # failures count toward the task's quarantine threshold, and
            # retried attempts honour the policy's deterministic backoff
            retry = getattr(req, "retry", None)
            fatal = worker is not None and getattr(worker, "crashed", False)
            if retry is not None and fatal \
                    and retry.quarantine_after is not None:
                n = self._fail_counts.get(req.task_id, 0) + 1
                self._fail_counts[req.task_id] = n
                if n >= retry.quarantine_after:
                    now = self._clock()
                    self._results[req.task_id] = EvalResult(
                        task_id=req.task_id, status="quarantined",
                        error=error, worker=worker.name, attempts=attempt,
                        submit_t=req.submit_t, start_t=now, end_t=now)
                    if self.tracer is not None:
                        since = entry[2] if entry is not None else now
                        self.tracer.task_quarantined(req.task_id, attempt,
                                                     now, since)
                    self._cancel_copies(req.task_id, now)
                    self._notify_result(req, self._results[req.task_id])
                    self._release_dependents()
                    self._cv.notify_all()
                    return
            # attempts are bounded by BOTH the executor-wide limit and the
            # request's own max_attempts (which simulate_cluster honours —
            # live and sim must agree on when a task is spent)
            if attempt < min(self.max_attempts, req.max_attempts):
                self._cv.notify_all()
                if retry is not None and retry.base_s > 0.0 \
                        and self._stepper is not None:
                    # deferred requeue: the monitor's next step() past
                    # the release time pushes it (exponential backoff
                    # with the policy's seeded jitter)
                    release = self._clock() + retry.backoff_s(
                        req.task_id, attempt, seed=self.retry_seed)
                    self._stepper.defer_push(req, attempt + 1, release)
                else:
                    self._push(req, attempt + 1)
            else:
                # terminal shape matches the sim's killed_task_record:
                # start_t == end_t (the failure instant), zero cpu time
                now = self._clock()
                self._results[req.task_id] = EvalResult(
                    task_id=req.task_id, status="failed", error=error,
                    worker=worker.name, attempts=attempt,
                    submit_t=req.submit_t, start_t=now, end_t=now)
                if self.tracer is not None:
                    self.tracer.task_failed(req.task_id, attempt, ts=now)
                self._notify_result(req, self._results[req.task_id])
                self._release_dependents()
                self._cv.notify_all()

    def _release_dependents(self):
        still = []
        for req, attempt in self._waiting:
            if all(d in self._results for d in req.depends_on):
                self._push(req, attempt)
            else:
                still.append((req, attempt))
        self._waiting = still

    def _on_worker_death(self, worker: Worker):
        """Requeue whatever a dead worker was running (fault tolerance);
        the policy reflows any per-worker queue state it held."""
        with self._cv:
            if worker in self.workers:
                self.workers.remove(worker)
            self.policy.remove_worker(worker.wid)
            for table in (self._running, self._hedges):
                dead = [tid for tid, (_, w, _, _) in table.items()
                        if w is worker]
                for tid in dead:
                    req, _, _, attempt = table.pop(tid)
                    self._push(req, attempt)   # the crash was not its fault
            if worker.alloc is not None and worker.alloc.virtual \
                    and worker.alloc.state == "running":
                # the surrogate queue is served ONLY by virtual workers
                # (routing/stealing exclude it): a dead one must be
                # replaced or trusted tasks would queue there forever
                self._add_worker(worker.alloc)
            self._cv.notify_all()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, req: EvalRequest) -> str:
        with self._cv:
            if self.backlog_limit is not None:
                while len(self.policy) >= self.backlog_limit:
                    self._cv.wait(0.01)
            req.submit_t = self._clock()
            self._requests[req.task_id] = req
            if req.depends_on and not all(d in self._results
                                          for d in req.depends_on):
                self._waiting.append((req, 1))
            else:
                self._push(req, 1)
        return req.task_id

    def result(self, task_id: str, timeout: float = 300.0) -> EvalResult:
        deadline = time.monotonic() + timeout
        with self._cv:
            while task_id not in self._results:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(task_id)
                self._cv.wait(min(left, 0.05))
            return self._results[task_id]

    def run_all(self, reqs: Sequence[EvalRequest], timeout: float = 600.0
                ) -> List[EvalResult]:
        ids = [self.submit(r) for r in reqs]
        return [self.result(t, timeout) for t in ids]

    def evaluate(self, model_name: str, parameters, config=None,
                 timeout: float = 300.0):
        """Synchronous UM-Bridge-style call through the scheduler."""
        req = EvalRequest(model_name=model_name, parameters=parameters,
                          config=config or {})
        self.submit(req)
        res = self.result(req.task_id, timeout)
        if res.status != "ok":
            raise RuntimeError(f"{model_name} failed: {res.error}")
        return res.value

    # ------------------------------------------------------------------
    # elasticity / fault injection / introspection
    # ------------------------------------------------------------------
    # real threads serve the queue; the parity harness flips this off and
    # plays the worker objects deterministically on a virtual clock
    _threaded = True

    def _add_worker(self, alloc=None):
        wid = getattr(self, "_wid_counter", 0)
        self._wid_counter = wid + 1
        w = Worker(self, wid, alloc=alloc if alloc is not None
                   else self._initial_alloc)
        self.workers.append(w)
        if self._threaded:
            w.start()

    def scale_to(self, n: int):
        """Resize the pool by hand (autoalloc-managed groups are the
        allocator's business — scale those via its config).  New workers
        join the oldest OPEN allocation; if every group has been drained
        away (autoalloc with min_allocations=0), a fresh unbounded one is
        brought up — workers must never be pinned to a retired group the
        broker no longer routes to."""
        from repro_torch.cluster.allocation import Allocation
        with self._lock:
            if self.max_workers is not None:
                n = min(n, self.max_workers)
            target = self._initial_alloc
            if self._cluster_mode:
                open_allocs = [a for a in self.policy.allocations()
                               if a.state == "running" and not a.virtual]
                if open_allocs:
                    target = open_allocs[0]
                elif self._n_real_workers() < n:   # all groups gone: new one
                    now = self._clock()
                    target = Allocation(self.policy.next_alloc_id(), 0,
                                        None)
                    target.submit(now, 0.0)
                    target.tick(now)
                    self.policy.add_allocation(target)
            now = self._clock()
            while self._n_real_workers() < n:
                self._add_worker(target)
                target.resize(target.n_workers + 1, now)
            while self._n_real_workers() > n:
                # shrink pops the newest REAL worker; the virtual
                # surrogate server is not capacity and stays up
                w = next(w for w in reversed(self.workers)
                         if w.alloc is None or not w.alloc.virtual)
                self.workers.remove(w)
                w.alive = False
                self.policy.remove_worker(w.wid)
                if w.alloc is not None:        # time-weighted billing
                    w.alloc.resize(w.alloc.n_workers - 1, now)

    def kill_worker(self, idx: int = 0):
        """Fault injection: hard-kill one worker (tests, chaos drills)."""
        with self._lock:
            if idx < len(self.workers):
                self.workers[idx].crashed = True

    def backlog(self) -> int:
        with self._lock:
            return len(self.policy)

    def n_workers(self) -> int:
        return len([w for w in self.workers if w.alive])

    def _n_real_workers(self) -> int:
        """Workers on real allocations (virtual surrogate servers are not
        capacity and never count against `max_workers`)."""
        return len([w for w in self.workers
                    if w.alloc is None or not w.alloc.virtual])

    def _cluster_step(self):
        """One canonical lifecycle tick (monitor thread): the shared
        `LifecycleStepper` — the SAME state machine `simulate_cluster`
        drives on a virtual clock — runs here against this executor's
        clock, with thread spawn/teardown as its mechanism callbacks."""
        with self._cv:
            self._stepper.step(self._clock())
            self._cv.notify_all()

    # -- stepper mechanism callbacks (all run under the dispatch lock) --
    def _spawn_group(self, alloc):
        for _ in range(alloc.n_workers):
            self._add_worker(alloc)

    def _retire_group(self, alloc):
        """Tear down an allocation's worker threads; hand the stepper the
        in-flight tasks that died with them (it bills their partial busy
        time and decides requeue-vs-fail — the one walltime-kill rule)."""
        killed = []
        for w in [w for w in self.workers if w.alloc is alloc]:
            w.alive = False
            self.workers.remove(w)
            self.policy.remove_worker(w.wid)
            for table in (self._running, self._hedges):
                for tid in [tid for tid, (_, rw, _, _) in table.items()
                            if rw is w]:
                    req, _, t_start, attempt = table.pop(tid)
                    killed.append((req, attempt, t_start))
        return killed

    def _busy_by_alloc(self) -> Dict[int, int]:
        busy: Dict[int, int] = {}
        for table in (self._running, self._hedges):
            for _req, w, _t, _a in table.values():
                if w is not None and w.alloc is not None:
                    busy[w.alloc.alloc_id] = busy.get(w.alloc.alloc_id,
                                                      0) + 1
        return busy

    def _worker_busy(self, worker: Worker) -> bool:
        return any(e[1] is worker for e in self._running.values()) or \
            any(e[1] is worker for e in self._hedges.values())

    def _record_expired(self, req, attempt, alloc, now: float):
        """Terminal record for a walltime-killed task with every attempt
        spent — the canonical `metrics.killed_task_record` shape."""
        if self._already_done(req.task_id):
            return
        self._results[req.task_id] = EvalResult(
            task_id=req.task_id, status="failed",
            error="allocation expired", worker=f"alloc{alloc.alloc_id}",
            attempts=attempt, submit_t=req.submit_t,
            start_t=now, end_t=now)
        self._cancel_copies(req.task_id, now)
        self._notify_result(req, self._results[req.task_id])
        self._release_dependents()

    def _record_quarantined(self, req, attempt, alloc, now: float):
        """Terminal record for a task quarantined by the stepper's
        retry rule (N worker-killing failures): canonical killed shape
        with status 'quarantined'."""
        if self._already_done(req.task_id):
            return
        self._results[req.task_id] = EvalResult(
            task_id=req.task_id, status="quarantined",
            error="quarantined after repeated worker-killing failures",
            worker=f"alloc{alloc.alloc_id}", attempts=attempt,
            submit_t=req.submit_t, start_t=now, end_t=now)
        self._cancel_copies(req.task_id, now)
        self._notify_result(req, self._results[req.task_id])
        self._release_dependents()

    def _notify_result(self, req: EvalRequest, res: EvalResult):
        """Fire the `on_result` hook for a just-stored result.  Runs
        under the dispatch lock; the hook is best-effort — accounting
        failures must never take dispatch down with them."""
        if self.on_result is not None:
            try:
                self.on_result(req, res)
            except Exception:  # noqa: BLE001
                pass

    def _monitor_loop(self):
        while not self._stopping:
            time.sleep(self._monitor_interval)
            self.step()

    def step(self):
        """One monitor pass: lifecycle tick (cluster mode) + straggler
        re-issue.  Public so a virtual-clock driver (`repro_torch.cluster.
        parity`) can pump the executor without the monitor thread."""
        if self._cluster_mode:
            self._cluster_step()
        if self.straggler_factor > 0:
            self._straggler_check(self._clock())

    def _straggler_check(self, now: float):
        """Speculatively re-issue tasks running far beyond their MODEL'S
        p95 (`repro_torch.chaos.find_stragglers` — the one ladder the simulator
        also runs, so a parity replay hedges the same tasks at the same
        times).  A pooled p95 misfires on heterogeneous models: the fast
        model's p95 re-issues every healthy task of a slow model, doubling
        exactly the work that is already the bottleneck.

        Cluster mode is capacity-gated: hedges launch only when the queue
        is drained and idle real workers exist (at most one hedge per
        idle worker per tick), and the copy runs as ``attempt + 1`` so
        its trace span is distinguishable from the original's.  The
        plain-pool path keeps the legacy ungated behaviour."""
        with self._lock:
            if self.straggler_factor <= 0.0:
                return
            completions = []
            for tid, r in self._results.items():
                if r.status != "ok" or r.worker.endswith("-surrogate"):
                    continue       # ms-scale surrogate hits would crater p95
                r_req = self._requests.get(tid)
                if r_req is not None:
                    completions.append((r_req.model_name, r.compute_t))
            idle_n = None
            if self._cluster_mode:
                if len(self.policy):
                    return         # hedge on SPARE capacity only
                idle_n = len([w for w in self.workers
                              if w.alloc is not None and not w.alloc.virtual
                              and w.alloc.state == "running"
                              and not self._worker_busy(w)])
                if idle_n == 0:
                    return
            cands = sorted(((tid, req.model_name, t_start, attempt)
                            for tid, (req, _w, t_start, attempt)
                            in self._running.items()
                            if not req.config.get("_speculated")
                            and not req.config.get("_surrogate")),
                           key=lambda c: (c[2], c[0]))
            ids = find_stragglers(
                now, [(c[0], c[1], c[2]) for c in cands], completions,
                predictor=self.predictor, factor=self.straggler_factor,
                min_n=self.straggler_min_completed)
            if idle_n is not None:
                ids = ids[:idle_n]
            by_id = {c[0]: c for c in cands}
            for tid in ids:
                _, _, t_start, attempt = by_id[tid]
                req = self._running[tid][0]
                req.config["_speculated"] = True
                # the copy must duplicate the SAME work: re-deciding the
                # serving path here could stamp _surrogate on the shared
                # config while the real attempt is in flight, and a
                # first-to-finish GP answer would silently replace (and
                # discard) the real result
                req.config["_no_surrogate"] = True
                if self._cluster_mode:
                    if self.tracer is not None:
                        self.tracer.task_speculate(tid, attempt + 1, now,
                                                   t_start)
                    self._push(req, attempt + 1)
                else:
                    self._push(req, 1)

    # ------------------------------------------------------------------
    # checkpoint / restart
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Serialisable queue state: done ids + pending request payloads
        + the predictor's learned state (where it supports persistence —
        engine backend name and conditioning set included, so a restored
        broker re-costs with the SAME surrogate backend instead of
        silently falling back to a cold default)."""
        with self._lock:
            pending = [req for req, _ in self.policy.pending()]
            pending += [req for req, _ in self._waiting]
            pending += [req for req, _, _, _ in self._running.values()]
            # a retry in its backoff (RetryPolicy.base_s > 0, cluster mode)
            # sits in the stepper until its release time: neither queued
            # nor running, so the reference's snapshot drops it and a
            # journal written then never runs it again.  The port lists
            # it as pending (`_fail` defers it under this same lock).
            if self._stepper is not None:
                pending += self._stepper.deferred_requests()
            sd = getattr(self.predictor, "state_dict", None)
            return {
                "completed": {tid: {"value": r.value, "status": r.status}
                              for tid, r in self._results.items()},
                "pending": [{
                    "model_name": r.model_name, "parameters": r.parameters,
                    "config": {k: v for k, v in r.config.items()
                               if not k.startswith("_")},
                    "task_id": r.task_id,
                    "time_request": r.time_request,
                    "time_limit": r.time_limit,
                    "n_cpus": r.n_cpus,
                    "max_attempts": r.max_attempts,
                    "deadline": r.deadline,
                    "tenant": r.tenant,
                    "retry": (dataclasses.asdict(r.retry)
                              if r.retry is not None else None),
                    "depends_on": list(r.depends_on),
                } for r in pending],
                "predictor": sd() if callable(sd) else None,
            }

    @classmethod
    def restore(cls, snap: Dict[str, Any],
                model_factories: Dict[str, Callable[[], Model]],
                **kw) -> "Executor":
        ex = cls(model_factories, **kw)
        pred_state = snap.get("predictor")
        if pred_state and ex.predictor is not None:
            # before any resubmission, so the very first re-costing pass
            # already uses the persisted posterior
            ls = getattr(ex.predictor, "load_state", None)
            if callable(ls):
                ls(pred_state)
        with ex._lock:
            for tid, r in snap["completed"].items():
                ex._results[tid] = EvalResult(task_id=tid, value=r["value"],
                                              status=r["status"])
        for p in snap["pending"]:
            ex.submit(EvalRequest(**p))
        return ex

    # ------------------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """Executor-level counters.  `server_init_total_t` is the true
        cumulative warmup cost across all server instantiations — visible
        even though warm reuses report `init_t == 0` per result."""
        with self._lock:
            by_status: Dict[str, int] = {}
            for r in self._results.values():
                by_status[r.status] = by_status.get(r.status, 0) + 1
            sur = self._surrogate()
            offload = (dataclasses.asdict(sur.stats())
                       if sur is not None else None)
            attribution = None
            if self.tracer is not None:
                from repro_torch.obs.attribution import attribute_overhead
                attribution = attribute_overhead(
                    self.tracer.events())["totals"]
            return {
                "offload": offload,
                "stepper_events": (list(self._stepper.events)
                                   if self._stepper is not None else []),
                "overhead_attribution": attribution,
                "server_init_total_t": self._init_total_t,
                "server_inits": self._init_count,
                "policy": self.policy.name,
                "backlog": len(self.policy),
                "running": len(self._running),
                "waiting_on_deps": len(self._waiting),
                "workers_alive": self.n_workers(),
                "results_by_status": by_status,
                # real allocations only: the virtual surrogate allocation
                # is invisible to every other capacity metric too
                "allocations_open": (len([a for a in
                                          self.policy.allocations()
                                          if a.open and not a.virtual])
                                     if self._cluster_mode else 1),
                "allocations_total": (len([a for a in
                                           self.policy.allocations()
                                           if not a.virtual])
                                      + len([a for a in self._retired_allocs
                                             if not a.virtual])
                                      if self._cluster_mode else 1),
            }

    def allocation_records(self) -> List[Any]:
        """`AllocationRecord`s for every allocation this executor owned
        (retired ones first) — feeds `metrics.node_seconds` /
        `metrics.allocation_utilization` exactly like `simulate_cluster`."""
        now = self._clock()
        with self._lock:
            live = (self.policy.allocations() if self._cluster_mode
                    else [self._initial_alloc])
            out = [a.record() for a in self._retired_allocs]
            out += [a.record(now) for a in live if a is not None]
            return sorted(out, key=lambda r: r.alloc_id)

    def records(self) -> List[TaskRecord]:
        with self._lock:
            out = []
            for r in self._results.values():
                out.append(TaskRecord(
                    task_id=r.task_id, submit_t=r.submit_t,
                    start_t=r.start_t, end_t=r.end_t,
                    cpu_time=r.cpu_time, compute_t=r.compute_t,
                    worker=r.worker, attempts=r.attempts, status=r.status))
            return out

    def shutdown(self):
        self._stopping = True
        now = self._clock()
        with self._cv:
            for w in self.workers:
                w.alive = False
            allocs = (self.policy.allocations() if self._cluster_mode
                      else [self._initial_alloc])
            for a in allocs:
                if a is not None:
                    a.terminate(now)           # close the billing window
            if self._cluster_mode:             # states changed out-of-band
                self.policy.invalidate_allocations()
            self._cv.notify_all()
        for w in self.workers:
            if w.ident is not None:            # never-started replay workers
                w.join(timeout=1.0)
            # Port change: a stopped worker releases its persistent servers
            # (their weights on the device) now, not when a collector
            # breaks the executor's reference cycles.
            if not w.is_alive():
                w.servers.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
