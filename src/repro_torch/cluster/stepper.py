"""One lifecycle stepper for sim and live: the canonical per-tick rules.

Before this module the allocation-lifecycle *driving rules* — when a
QUEUED allocation's grant spawns workers, how the `max_workers` headroom
cap binds a grant (and cancels one that gets zero headroom), what happens
to tasks still running at walltime expiry, when a DRAINING allocation is
terminated, and when the autoallocator gets to decide — were implemented
twice: once in `simulate_cluster` and once in `Executor._cluster_step`.
They had diverged in at least three observable ways (autoalloc stepped
before vs after transitions, the capacity cap missing from the sim,
terminal kill-record shapes disagreeing).  The whole point of the
simulator is that its elasticity numbers transfer to the live executor,
so the rules now live HERE and nowhere else.

Canonical per-tick phase order (the driver owns phases in [brackets]):

    [arrivals]                 new requests enter the broker
    [completions]              finished tasks leave workers, bill busy_t
    ------------------- LifecycleStepper.step(now) -------------------
    transitions                Allocation.tick: QUEUED->RUNNING grants
                               (headroom-capped spawn, zero-headroom
                               grant cancellation) and walltime expiry
    walltime kill              expired groups: workers torn down, partial
                               busy billed, killed tasks requeued at
                               attempt+1 or terminally failed
    drained dry                DRAINING groups with zero busy workers are
                               terminated (node-seconds stop burning)
    autoalloc                  AutoAllocator.step sees POST-transition
                               capacity (the sim order; the live path
                               used to step it first)
    ------------------------------------------------------------------
    [dispatch]                 idle workers pop from the broker

The stepper is clock-agnostic and mechanism-agnostic: it owns the
*decisions* and their order, while the driver supplies the mechanism
through callbacks — `now` (virtual clock or `time.monotonic`),
`spawn_workers` (dict of sim workers or live threads), `retire_workers`
(tear a group down, returning the in-flight tasks that died with it),
`busy_count`/`worker_count` (occupancy views), and `record_failed` (the
driver's terminal-record sink).  `simulate_cluster` and the live
`Executor` are thin adapters over one instance each, so the two paths
cannot diverge again.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.cluster.allocation import (DRAINING, EXPIRED, QUEUED, RUNNING,
                                      Allocation)
from repro_torch.obs.trace import RingBuffer

# (request, attempt, busy-since): one in-flight task killed with its group
KilledTask = Tuple[Any, int, float]

# (t, kind, alloc_id, n): kind in {"spawn", "kill", "drain-dry", "cancel"};
# n is workers spawned (spawn) or in-flight tasks killed (retirements)
StepperEvent = Tuple[float, str, int, int]


class LifecycleStepper:
    """The single allocation-lifecycle state machine shared by the
    discrete-event simulator and the live executor.

    Parameters
    ----------
    broker:        the `Broker` holding allocations and queues (requeues
                   of killed tasks go back through ``broker.push``).
    allocator:     optional `AutoAllocator`; stepped LAST, after every
                   state transition of the tick.
    now:           clock callback; ``step()`` uses it when no explicit
                   ``now`` is passed (the sim passes its event time).
    spawn_workers: bring up ``alloc.n_workers`` workers for a granted
                   allocation.
    retire_workers: tear down an allocation's workers; returns the killed
                   in-flight tasks as ``(request, attempt, busy_since)``.
                   The stepper bills their partial busy time and decides
                   requeue-vs-fail — the driver must do neither.
    busy_count:    ``{alloc_id: busy workers}`` (zero entries may be
                   omitted; the stepper zero-fills).
    worker_count:  real (non-virtual) workers currently up — the headroom
                   base for the `max_workers` cap.  Defaults to summing
                   ``n_workers`` over RUNNING/DRAINING real allocations.
    record_failed: sink for a terminally-failed killed task
                   ``(request, attempt, alloc, now)``; the canonical
                   record shape is `metrics.killed_task_record`.
    max_workers:   total real-worker ceiling (None = uncapped).  A grant
                   is resized down to the available headroom; a grant
                   with zero headroom is cancelled outright.
    max_attempts:  driver-wide attempt bound, combined with each
                   request's own ``max_attempts`` (None = request-level
                   bound only, the sim default).
    retired:       list retired allocations are appended to (the driver's
                   record store); a fresh list when omitted.
    tracer:        optional `repro_torch.obs.Tracer` — the stepper is the one
                   choke point where allocation transitions, walltime
                   requeues/kills, and autoalloc actions happen, so one
                   set of spans/instants emitted here covers sim and
                   live identically.
    registry:      optional `repro_torch.obs.MetricsRegistry`, sampled once
                   per `step` (queue depth, backlog cost, busy workers,
                   allocation counts, offload rate).
    events_cap:    audit-trail bound — `events` is a ring buffer so a
                   long-lived executor cannot grow it without limit.
    """

    def __init__(self, broker, allocator=None, *,
                 now: Callable[[], float],
                 spawn_workers: Callable[[Allocation], None],
                 retire_workers: Callable[[Allocation], List[KilledTask]],
                 busy_count: Callable[[], Dict[int, int]],
                 record_failed: Callable[[Any, int, Allocation, float], None],
                 worker_count: Optional[Callable[[], int]] = None,
                 max_workers: Optional[int] = None,
                 max_attempts: Optional[int] = None,
                 retired: Optional[List[Allocation]] = None,
                 tracer: Any = None, registry: Any = None,
                 calibration: Any = None,
                 on_tick: Optional[Callable[[float], None]] = None,
                 record_quarantined: Optional[
                     Callable[[Any, int, Allocation, float], None]] = None,
                 retry_seed: int = 0,
                 events_cap: int = 10_000):
        self.broker = broker
        self.allocator = allocator
        self.now = now
        self.spawn_workers = spawn_workers
        self.retire_workers = retire_workers
        self.busy_count = busy_count
        self.record_failed = record_failed
        self.worker_count = worker_count
        self.max_workers = max_workers
        self.max_attempts = max_attempts
        self.retired: List[Allocation] = retired if retired is not None \
            else []
        self.tracer = tracer
        self.registry = registry
        # optional repro_torch.obs.calib.CalibrationMonitor: the grant is the
        # one place (shared by sim and live) where an allocation's drawn
        # queue wait becomes an observed fact, so residuals against the
        # spec's queue-wait model are fed from here
        self.calibration = calibration
        # end-of-tick hook: the one cadence point shared by sim and live
        # (`repro_torch.service` hangs its journal snapshots here, so a
        # virtual-clock test and a wall-clock service checkpoint on the
        # same schedule).  Runs under the driver's dispatch lock.
        self.on_tick = on_tick
        # spawn/retire audit trail, bounded (oldest entries drop first;
        # `events.n_dropped` says how many a long run shed)
        self.events: RingBuffer = RingBuffer(events_cap)
        # -- hardened recovery (repro_torch.chaos) ----------------------------
        # terminal sink for quarantined poison tasks; record_failed is
        # the fallback so legacy drivers need no new callback
        self.record_quarantined = record_quarantined
        # seed for RetryPolicy's deterministic backoff jitter — both
        # parity drivers must carry the same one
        self.retry_seed = int(retry_seed)
        # optional ChaosInjector, fired at the top of every step (set
        # post-hoc by the driver; None = fault-free)
        self.chaos = None
        # requeues released later than the kill (RetryPolicy backoff):
        # (release_t, seq, request, attempt), pushed back to the broker
        # by the first step at/after release_t.  The seq breaks ties in
        # arrival order, deterministically.
        self._deferred: List[Tuple[float, int, Any, int]] = []
        self._defer_seq = 0
        # fatal (worker-killing) failure counts per task, for quarantine
        self._fail_counts: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def step(self, now: Optional[float] = None) -> float:
        """One canonical tick: deferred-requeue release -> chaos faults ->
        transitions (grants + walltime kills) -> drained-dry termination
        -> autoalloc decisions."""
        if now is None:
            now = self.now()
        self._release_deferred(now)
        if self.chaos is not None:
            self.chaos.fire(now)
        self._transitions(now)
        self._drained_dry(now)
        sur = getattr(self.broker, "surrogate", None)
        if sur is not None and hasattr(sur, "tick_degraded"):
            sur.tick_degraded(now)         # outage/drift re-arm point
        if self.allocator is not None:
            actions = self.allocator.step(now, self.broker, self._busy())
            if self.tracer is not None and actions:
                for action, alloc in actions:
                    self.tracer.instant(
                        f"autoalloc.{action}", ts=now,
                        args={"alloc": alloc.alloc_id,
                              "n_workers": alloc.n_workers})
        if self.registry is not None:
            self.registry.sample_cluster(
                now, self.broker, sum(self.busy_count().values()))
        if self.on_tick is not None:
            self.on_tick(now)
        return now

    def release(self, now: float) -> None:
        """Driver wind-down: unregister every allocation still held (a
        still-QUEUED one is cancelled for 0 node-seconds, as scancel
        would) and keep them for the record."""
        for alloc in list(self.broker.allocations()):
            self.broker.remove_allocation(alloc.alloc_id, now)
            self.retired.append(alloc)

    # -- phases ---------------------------------------------------------
    def _transitions(self, now: float) -> None:
        for alloc in list(self.broker.allocations()):
            prev = alloc.state
            state = alloc.tick(now)
            if state != prev:
                # tick mutates allocation state outside the broker's own
                # methods; its cached allocation views must not go stale
                self.broker.invalidate_allocations()
                if self.tracer is not None:
                    self.tracer.alloc_state(alloc, ts=now)
            if prev == QUEUED and state == RUNNING:
                self._grant(alloc, now)
            elif prev in (RUNNING, DRAINING) and state == EXPIRED:
                self._retire(alloc, now, "kill")

    def _grant(self, alloc: Allocation, now: float) -> None:
        """Nodes granted: spawn the group, capped at the `max_workers`
        headroom.  Virtual (surrogate) allocations are not real capacity
        and are exempt.  A grant that gets zero headroom is cancelled —
        the autoallocator's own `worker_cap` normally prevents the
        submit, but a cap can tighten after submission."""
        if not alloc.virtual and self.max_workers is not None:
            headroom = max(self.max_workers - self._real_workers(alloc), 0)
            if headroom < alloc.n_workers:
                alloc.resize(headroom, now)
            if alloc.n_workers == 0:
                self._retire(alloc, now, "cancel")
                return
        if self.calibration is not None and not alloc.virtual:
            self.calibration.observe_queue_wait(alloc, now)
        self._event(now, "spawn", alloc.alloc_id, alloc.n_workers)
        self.spawn_workers(alloc)

    def _drained_dry(self, now: float) -> None:
        busy = self._busy()
        for alloc in list(self.broker.allocations()):
            if alloc.state == DRAINING and busy.get(alloc.alloc_id, 0) == 0:
                alloc.terminate(now)
                self._retire(alloc, now, "drain-dry")

    # -- retirement (the one walltime-kill / teardown rule) -------------
    def _retire(self, alloc: Allocation, now: float, kind: str) -> None:
        killed = self.retire_workers(alloc)
        for _req, _attempt, since in killed:
            alloc.note_busy(max(now - since, 0.0))   # partial work burned
        self._event(now, kind, alloc.alloc_id, len(killed))
        self.broker.remove_allocation(alloc.alloc_id, now)
        if self.tracer is not None:
            self.tracer.alloc_state(alloc, ts=now)   # terminal span
        self.retired.append(alloc)
        for req, attempt, since in killed:
            self.requeue_or_fail(req, attempt, since, now, alloc)

    # -- the one requeue-vs-quarantine-vs-fail rule ---------------------
    def requeue_or_fail(self, req, attempt: int, since: float, now: float,
                        alloc: Allocation, *, fatal: bool = False,
                        migrate: bool = False) -> str:
        """Route one killed in-flight attempt.  The caller has already
        billed the burned ``[since, now]`` interval to the allocation;
        this decides what happens to the TASK — requeue (immediately, or
        deferred by the request's `RetryPolicy` backoff), quarantine
        (``fatal=True`` failures — worker crashes, corrupted results —
        past ``quarantine_after``), or terminal failure when attempts are
        spent.  ``migrate=True`` (preemption-grace drain) requeues at the
        SAME attempt with no backoff: migration is not the task's fault.
        Returns the route taken ("requeued" | "quarantined" | "failed")."""
        retry = getattr(req, "retry", None)
        if fatal and retry is not None \
                and retry.quarantine_after is not None:
            n = self._fail_counts.get(req.task_id, 0) + 1
            self._fail_counts[req.task_id] = n
            if n >= retry.quarantine_after:
                if self.tracer is not None:
                    self.tracer.task_quarantined(req.task_id, attempt,
                                                 now, since)
                sink = self.record_quarantined or self.record_failed
                sink(req, attempt, alloc, now)
                return "quarantined"
        if migrate or attempt < self._attempt_limit(req):
            next_attempt = attempt if migrate else attempt + 1
            release = now
            if retry is not None and not migrate:
                release = now + retry.backoff_s(req.task_id, attempt,
                                                seed=self.retry_seed)
            if self.tracer is not None:
                self.tracer.task_requeue(req.task_id, attempt, now, since,
                                         release=release)
            if release > now:
                self.defer_push(req, next_attempt, release)
            else:
                self.broker.push(req, next_attempt)
            return "requeued"
        if self.tracer is not None:
            self.tracer.task_killed(req.task_id, attempt, now, since)
        self.record_failed(req, attempt, alloc, now)
        return "failed"

    # -- deferred (backed-off) requeues ---------------------------------
    def defer_push(self, req, attempt: int, release: float) -> None:
        self._defer_seq += 1
        self._deferred.append((float(release), self._defer_seq, req,
                               attempt))

    def deferred_times(self) -> List[float]:
        """Pending release times — event-time candidates for the sim's
        next-event search (a release must land ON an event time or the
        requeue timestamp drifts off the parity trace)."""
        return [d[0] for d in self._deferred]

    def deferred_requests(self) -> List[Any]:
        """Requests held back until their release time (retries in their
        backoff), in the order they were deferred."""
        return [d[2] for d in self._deferred]

    def _release_deferred(self, now: float) -> None:
        if not self._deferred:
            return
        due = sorted(d for d in self._deferred if d[0] <= now)
        if not due:
            return
        self._deferred = [d for d in self._deferred if d[0] > now]
        for _release, _seq, req, attempt in due:
            self.broker.push(req, attempt)

    def _event(self, now: float, kind: str, alloc_id: int, n: int) -> None:
        self.events.append((now, kind, alloc_id, n))
        if self.tracer is not None:
            self.tracer.instant(f"alloc.{kind}", ts=now, pid=alloc_id + 1,
                                args={"alloc": alloc_id, "n": n})

    # -- views -----------------------------------------------------------
    def _attempt_limit(self, req) -> int:
        if self.max_attempts is None:
            return req.max_attempts
        return min(req.max_attempts, self.max_attempts)

    def _real_workers(self, granting: Allocation) -> int:
        """Headroom base at grant time: the granted group's own workers
        are not up yet, so it never counts against itself."""
        if self.worker_count is not None:
            return self.worker_count()
        return sum(a.n_workers for a in self.broker.allocations()
                   if a is not granting and not a.virtual
                   and a.state in (RUNNING, DRAINING))

    def _busy(self) -> Dict[int, int]:
        busy = {a.alloc_id: 0 for a in self.broker.allocations()}
        busy.update(self.busy_count())
        return busy
