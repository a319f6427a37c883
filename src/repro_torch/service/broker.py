"""Multi-tenant broker service: the always-on front-end over the
Executor.

This is the Balsam-shaped layer the ROADMAP calls for: the `Executor`
stays a single-process scheduling engine, and `ServiceBroker` turns it
into a *service* — a task-ingestion API multiple tenants share, with

  * fair-share dispatch: every allocation queue is a `FairSharePolicy`
    (weighted deficit round robin over the registered inner policy), so
    tenants split CPU-seconds by configured weight whenever they
    compete, and nobody starves (`repro_torch.sched.policy.FairSharePolicy`);
  * bounded-queue backpressure per tenant: `submit` blocks (or raises
    `Backpressure`) while a tenant is at its quota of OPEN tasks —
    submitted but not yet terminal — so one tenant's firehose cannot
    grow the broker's memory or queue latency without bound;
  * per-tenant SLO accounting: tenant-labelled counters in the
    `MetricsRegistry` (tasks submitted/done by status, CPU-seconds
    billed, deadline totals and misses) and a `billing()` view;
  * a crash-safe journal (`repro_torch.checkpoint.Journal`): queue contents,
    predictor state (engine backend + conditioning set) and billing are
    snapshotted on the lifecycle-tick cadence via atomic
    tmpfile+fsync+rename publishes.  `ServiceBroker.recover` restarts
    from the newest loadable journal with ZERO lost tasks — pending
    work is resubmitted, completed results are pre-filled, the
    predictor resumes with the same surrogate backend.  Re-running
    tasks that finished after the last snapshot is allowed
    (at-least-once semantics); losing one is not.

Mechanically this is the third adapter around the same
`LifecycleStepper` that drives `simulate_cluster` and the bare cluster
Executor: the service installs the fair-share policy per allocation
through the same `Broker`, hangs its journal cadence on the canonical
stepper tick, and so inherits the parity harness's guarantee that
sim-validated fair-share pop order is exactly what dispatches live.

Locking: the service lock is always LEAF.  `submit` releases it before
entering the executor; executor-held paths (`_on_result`, the stepper
tick) may take it.  The reverse order never occurs, so the service
cannot deadlock against the dispatch lock.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.journal import Journal
from repro_torch.cluster.broker import Broker
from repro_torch.core.executor import Executor
from repro_torch.core.task import DEFAULT_TENANT, EvalRequest, EvalResult
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.sched.policy import FairSharePolicy
from repro_torch.sched.registry import make_predictor


class Backpressure(RuntimeError):
    """A tenant is at its open-task quota and `submit` was non-blocking
    (or timed out)."""

    def __init__(self, tenant: str, open_tasks: int, quota: int):
        super().__init__(
            f"tenant {tenant!r} at quota: {open_tasks}/{quota} tasks open")
        self.tenant = tenant
        self.open_tasks = open_tasks
        self.quota = quota


class ServiceBroker:
    """Crash-safe, fair-share multi-tenant scheduling service.

    Parameters
    ----------
    model_factories: the executor's model registry.
    weights:         per-tenant fair-share weights (unlisted tenants
                     weigh 1.0; weight 4 gets 4x the CPU-second share of
                     weight 1 whenever both are backlogged).
    quotas:          per-tenant cap on OPEN tasks (admission control;
                     unlisted tenants are uncapped).
    inner_policy:    registered policy name each tenant's private queue
                     runs ("fcfs", "sjf", "pack", ...).
    predictor:       runtime-predictor spec shared by all tenants.
    quantum_s:       fair-share quantum (cost-seconds credited per
                     tenant-weight unit per round).
    journal_dir:     enable crash-safe journaling into this directory
                     (None = stateless service).
    journal_every_s: journal cadence on the executor's clock.
    journal_keep:    journals retained (keep-N gc).
    registry:        `MetricsRegistry` for tenant-labelled series (one
                     is created when omitted).
    fault_plan:      optional `repro_torch.chaos.FaultPlan` wired into the
                     live executor via `attach_chaos` (crash drills,
                     torn-journal tests); None = no fault injection.
    executor_kw:     everything else (`n_workers`, `autoalloc`, `clock`,
                     `monitor_interval`, `tracer`, ...) is passed to the
                     `Executor` — a virtual-clock service for tests is
                     just ``clock=..., monitor_interval=None``.
    """

    def __init__(self, model_factories: Dict[str, Callable], *,
                 weights: Optional[Dict[str, float]] = None,
                 quotas: Optional[Dict[str, int]] = None,
                 inner_policy: str = "fcfs",
                 predictor: Any = None,
                 quantum_s: float = 1.0,
                 journal_dir: Optional[str] = None,
                 journal_every_s: float = 5.0,
                 journal_keep: int = 3,
                 registry: Optional[MetricsRegistry] = None,
                 fault_plan: Any = None,
                 **executor_kw):
        self.weights = {str(t): float(w)
                        for t, w in (weights or {}).items()}
        self.quotas = {str(t): int(q) for t, q in (quotas or {}).items()}
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._open: Dict[str, int] = {}        # tenant -> open tasks
        self._tenant_of: Dict[str, str] = {}   # open task id -> tenant
        self._billing: Dict[str, float] = {}   # tenant -> cpu-seconds
        self._journal = Journal(journal_dir, keep=journal_keep) \
            if journal_dir is not None else None
        self.journal_every_s = float(journal_every_s)
        self._last_journal_t: Optional[float] = None
        self._killed = False
        # async journal writer: the stepper tick (under the dispatch
        # lock) only BUILDS the state dict; serialisation + fsync happen
        # on this thread so checkpoint IO never stalls dispatch
        self._wcv = threading.Condition()
        self._wstate: Optional[Dict[str, Any]] = None
        self._writer: Optional[threading.Thread] = None

        w, q, qu, sub = self.weights, self.quotas, quantum_s, inner_policy
        broker = Broker(
            predictor=make_predictor(predictor),
            policy=lambda: FairSharePolicy(policy=sub, weights=w,
                                           quotas=q, quantum_s=qu))
        self.broker = broker
        self._ex = Executor(model_factories, cluster=broker,
                            metrics_registry=self.registry,
                            on_result=self._on_result,
                            on_tick=self._on_tick,
                            **executor_kw)
        if self._journal is not None:
            self._last_journal_t = self._ex._clock()
            self._writer = threading.Thread(target=self._writer_loop,
                                            daemon=True)
            self._writer.start()
        self.chaos = None
        if fault_plan is not None and len(fault_plan):
            from repro_torch.chaos.inject import attach_chaos
            self.chaos = attach_chaos(self._ex, fault_plan,
                                      journal=self._journal)

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------
    def submit(self, req: EvalRequest, *, block: bool = True,
               timeout: Optional[float] = None) -> str:
        """Admit one request under its tenant's quota.

        At quota, `block=True` waits for a slot (bounded by `timeout`
        wall seconds); `block=False` raises `Backpressure` immediately.
        The admission ledger counts OPEN tasks — submitted and not yet
        terminal — so queue depth AND in-flight work both press back."""
        tenant = getattr(req, "tenant", "") or DEFAULT_TENANT
        quota = self.quotas.get(tenant)
        with self._cv:
            if quota is not None:
                deadline = (time.monotonic() + timeout
                            if timeout is not None else None)
                while self._open.get(tenant, 0) >= quota:
                    if not block:
                        raise Backpressure(tenant,
                                           self._open.get(tenant, 0), quota)
                    left = None if deadline is None \
                        else deadline - time.monotonic()
                    if left is not None and left <= 0:
                        raise Backpressure(tenant,
                                           self._open.get(tenant, 0), quota)
                    self._cv.wait(0.01 if left is None else min(left, 0.01))
            self._open[tenant] = self._open.get(tenant, 0) + 1
            self._tenant_of[req.task_id] = tenant
            self.registry.inc("tasks_submitted",
                              labels={"tenant": tenant})
        # OUTSIDE the service lock: the executor takes its dispatch lock
        # in submit, and executor-held paths call back into this lock —
        # holding both here would be the ABBA deadlock
        return self._ex.submit(req)

    def result(self, task_id: str, timeout: float = 300.0) -> EvalResult:
        return self._ex.result(task_id, timeout)

    def run_all(self, reqs, timeout: float = 600.0) -> List[EvalResult]:
        ids = [self.submit(r) for r in reqs]
        return [self.result(t, timeout) for t in ids]

    # ------------------------------------------------------------------
    # accounting (executor hooks — run under the dispatch lock, O(1))
    # ------------------------------------------------------------------
    def _on_result(self, req: EvalRequest, res: EvalResult) -> None:
        tenant = getattr(req, "tenant", "") or DEFAULT_TENANT
        labels = {"tenant": tenant}
        with self._cv:
            # billed per stored result: actual resource use, attempts
            # and superseded speculative results included
            self._billing[tenant] = self._billing.get(tenant, 0.0) \
                + float(res.cpu_time)
            self.registry.inc("cpu_seconds", v=float(res.cpu_time),
                              labels=labels)
            # admission slot frees on the FIRST terminal result only: a
            # "timeout" may later be superseded by a speculative "ok",
            # and that second store must not double-decrement
            if req.task_id in self._tenant_of:
                del self._tenant_of[req.task_id]
                self._open[tenant] = max(self._open.get(tenant, 0) - 1, 0)
                self.registry.inc(f"tasks_{res.status}", labels=labels)
                if req.deadline is not None:
                    self.registry.inc("deadline_total", labels=labels)
                    if res.end_t > req.deadline:
                        self.registry.inc("deadline_missed", labels=labels)
                self._cv.notify_all()

    def _on_tick(self, now: float) -> None:
        """Journal cadence, hung on the canonical stepper tick."""
        if self._journal is None or self._last_journal_t is None:
            return
        if now - self._last_journal_t < self.journal_every_s:
            return
        self._last_journal_t = now
        state = self._state()                  # dict building only
        with self._wcv:
            self._wstate = state               # newest snapshot wins
            self._wcv.notify()

    def _writer_loop(self) -> None:
        while True:
            with self._wcv:
                while self._wstate is None:
                    if self._killed:
                        return
                    self._wcv.wait(0.05)
                state, self._wstate = self._wstate, None
            try:
                self._journal.write(state)
            except Exception:  # noqa: BLE001 — journaling is best-effort;
                pass           # the next tick retries with fresher state

    # ------------------------------------------------------------------
    # journaling / recovery
    # ------------------------------------------------------------------
    def _state(self) -> Dict[str, Any]:
        snap = self._ex.snapshot()
        with self._cv:
            billing = dict(self._billing)
        return {"t": self._ex._clock(), "snapshot": snap,
                "billing": billing, "weights": dict(self.weights),
                "quotas": dict(self.quotas)}

    def checkpoint(self) -> Optional[str]:
        """Synchronously publish a journal snapshot now (tests, graceful
        shutdown); returns the published path."""
        if self._journal is None:
            return None
        return str(self._journal.write(self._state()))

    @classmethod
    def recover(cls, model_factories: Dict[str, Callable], *,
                journal_dir: str, **kw) -> "ServiceBroker":
        """Restart from the newest loadable journal in `journal_dir`.

        Completed results are pre-filled, the predictor reloads its
        persisted state (same engine backend, same conditioning set),
        billing resumes, and every pending task is resubmitted through
        normal admission — zero lost tasks.  An empty/absent journal
        directory yields a fresh service."""
        probe = Journal(journal_dir, keep=kw.get("journal_keep", 3))
        loaded = probe.latest()
        state = loaded[1] if loaded is not None else None
        if state is not None:
            kw.setdefault("weights", state.get("weights"))
            kw.setdefault("quotas", state.get("quotas"))
        svc = cls(model_factories, journal_dir=journal_dir, **kw)
        if state is None:
            return svc
        snap = state.get("snapshot", {})
        pred_state = snap.get("predictor")
        if pred_state and svc._ex.predictor is not None:
            loader = getattr(svc._ex.predictor, "load_state", None)
            if callable(loader):
                loader(pred_state)
        completed = snap.get("completed", {})
        with svc._ex._lock:
            for tid, r in completed.items():
                svc._ex._results[tid] = EvalResult(
                    task_id=tid, value=r["value"], status=r["status"])
        with svc._cv:
            svc._billing = {t: float(v)
                            for t, v in state.get("billing", {}).items()}
        done = {tid for tid, r in completed.items()
                if r["status"] in ("ok", "failed")}
        for p in snap.get("pending", []):
            if p["task_id"] in done:
                continue                       # finished before the crash
            svc.submit(EvalRequest(**p))
        return svc

    # ------------------------------------------------------------------
    # introspection / lifecycle
    # ------------------------------------------------------------------
    def billing(self) -> Dict[str, float]:
        """CPU-seconds billed per tenant (attempts included)."""
        with self._cv:
            return dict(self._billing)

    def open_tasks(self) -> Dict[str, int]:
        """Open (admitted, not yet terminal) tasks per tenant."""
        with self._cv:
            return {t: n for t, n in self._open.items() if n > 0}

    def records(self):
        return self._ex.records()

    def metrics(self) -> Dict[str, Any]:
        out = self._ex.metrics()
        out["billing"] = self.billing()
        out["open_tasks"] = self.open_tasks()
        out["tenant_backlogs"] = self.broker.tenant_backlogs()
        return out

    def step(self) -> None:
        """Pump one lifecycle tick (virtual-clock drivers)."""
        self._ex.step()

    def kill(self) -> None:
        """Crash simulation: hard-stop workers and the journal writer
        with NO final checkpoint and no allocation wind-down — what a
        SIGKILL leaves behind, minus the process exit.  Recovery must
        work from whatever the journal last published."""
        self._killed = True
        self._ex._stopping = True
        for worker in self._ex.workers:
            worker.alive = False
        with self._wcv:
            self._wcv.notify_all()

    def shutdown(self, *, final_checkpoint: bool = True) -> None:
        if self._journal is not None and not self._killed \
                and final_checkpoint:
            self.checkpoint()
        self._killed = True
        with self._wcv:
            self._wcv.notify_all()
        self._ex.shutdown()
        if self._writer is not None:
            self._writer.join(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
