"""`ChaosInjector`: fires a `FaultPlan` at the stepper choke point.

The injector owns no cluster state.  Drivers register per-kind handlers
(`on("worker_crash", fn)`); `LifecycleStepper.step` calls `fire(now)` at
the top of every step, which dispatches every event with ``t <= now`` to
its handler in plan order and emits one ``chaos.fire`` instant per event
— identical in sim and live because both drivers step the same stepper
at the same virtual times (fault fire times are event-time candidates in
both loops, so ``now`` lands exactly on each ``t``).

Two kinds are stateful rather than handled:

* ``corrupt_result`` increments a pending counter; the driver consumes
  it with `take_corruption()` at its next real (non-surrogate)
  completion, turning that completion into a fatal failed attempt.
* ``slow_node`` records a per-worker ``(factor, until)`` entry; drivers
  multiply compute by `slow_factor(wid, now)` at dispatch.  The victim
  worker id is resolved by the driver's handler (sorted running real
  workers) and registered via `set_slow`.

`attach_chaos` is the *best-effort* adapter for a threaded live
`Executor` (wall clock, non-deterministic interleaving): crashes set
`Worker.crashed`, preemptions clip-and-drain the victim allocation,
corruption consumes the same counter inside `_complete`.  Exactness is
the replay harness's contract, not the threaded one's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.chaos.plan import FaultEvent, FaultPlan


class ChaosInjector:
    """Deterministic fault pump over one `FaultPlan`."""

    def __init__(self, plan: FaultPlan, *, tracer: Any = None):
        self.plan = plan
        self.tracer = tracer
        self._i = 0
        self._corrupt_pending = 0
        self._slow: Dict[int, Tuple[float, float]] = {}   # wid -> (f, until)
        self._handlers: Dict[str, Callable[[FaultEvent, float], None]] = {}
        self.fired: List[FaultEvent] = []

    def on(self, kind: str,
           fn: Callable[[FaultEvent, float], None]) -> "ChaosInjector":
        self._handlers[kind] = fn
        return self

    # -- event-time plumbing ---------------------------------------------
    def next_time(self) -> Optional[float]:
        """Fire time of the next unfired event (an event-loop candidate:
        drivers must not step past it)."""
        if self._i < len(self.plan.events):
            return self.plan.events[self._i].t
        return None

    def pending_times(self) -> List[float]:
        return [e.t for e in self.plan.events[self._i:]]

    def fire(self, now: float) -> int:
        """Dispatch every due event; returns how many fired."""
        n = 0
        events = self.plan.events
        while self._i < len(events) and events[self._i].t <= now:
            ev = events[self._i]
            self._i += 1
            n += 1
            self.fired.append(ev)
            if self.tracer is not None:
                self.tracer.instant(
                    "chaos.fire", ts=now,
                    args={"kind": ev.kind, "target": ev.target})
            if ev.kind == "corrupt_result":
                self._corrupt_pending += 1
                continue
            fn = self._handlers.get(ev.kind)
            if fn is not None:
                fn(ev, now)
        return n

    # -- stateful kinds ---------------------------------------------------
    def take_corruption(self) -> bool:
        """Consume one pending result corruption (driver calls this at
        each real completion, in deterministic completion order)."""
        if self._corrupt_pending > 0:
            self._corrupt_pending -= 1
            return True
        return False

    def set_slow(self, wid: int, factor: float, until: float) -> None:
        self._slow[wid] = (float(factor), float(until))

    def slow_factor(self, wid: int, now: float) -> float:
        """Compute multiplier for worker ``wid`` at ``now`` (1.0 when
        healthy); expired slowdowns are dropped in passing."""
        entry = self._slow.get(wid)
        if entry is None:
            return 1.0
        factor, until = entry
        if now >= until:
            del self._slow[wid]
            return 1.0
        return factor


def attach_chaos(executor: Any, plan: FaultPlan, *,
                 journal: Any = None) -> ChaosInjector:
    """Wire a `FaultPlan` into a *threaded* live `Executor` (the
    `ServiceBroker` path).  Crashes flip `Worker.crashed` (the worker
    dies at its next dispatch), preemptions clip the victim allocation's
    walltime to the grace window and drain it, `journal_torn` arms the
    journal's torn-write flag; `slow_node` is a no-op on real hardware.
    Corruption is consumed by `Executor._complete` via the injector the
    executor now carries as ``_chaos``."""
    inj = ChaosInjector(plan, tracer=getattr(executor, "tracer", None))

    def _crash(ev: FaultEvent, now: float) -> None:
        workers = [w for w in getattr(executor, "workers", ())
                   if w.is_alive() and not w.crashed]
        if workers:
            workers[ev.target % len(workers)].crashed = True

    def _preempt(ev: FaultEvent, now: float) -> None:
        broker = getattr(executor, "_broker", None)
        if broker is None:
            return
        allocs = sorted((a for a in broker.allocations()
                         if not a.virtual and a.state == "running"),
                        key=lambda a: a.alloc_id)
        if not allocs:
            return
        victim = allocs[ev.target % len(allocs)]
        deadline = now + ev.duration_s
        if deadline < victim.expiry_t:
            victim.walltime_s = deadline - victim.grant_t
        broker.drain_allocation(victim.alloc_id, now)

    def _torn(ev: FaultEvent, now: float) -> None:
        if journal is not None:
            journal.torn_next = True

    def _outage(ev: FaultEvent, now: float) -> None:
        sur = getattr(getattr(executor, "_broker", None), "surrogate", None)
        if sur is not None and hasattr(sur, "set_degraded"):
            sur.set_degraded(now, now + ev.duration_s, "outage")

    inj.on("worker_crash", _crash)
    inj.on("preempt", _preempt)
    inj.on("journal_torn", _torn)
    inj.on("surrogate_outage", _outage)
    executor._chaos = inj
    stepper = getattr(executor, "_stepper", None)
    if stepper is not None:
        stepper.chaos = inj
    return inj
