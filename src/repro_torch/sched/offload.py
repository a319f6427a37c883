"""Surrogate-offload routing: variance-gated dispatch to a GP surrogate.

The paper's headline saving for long-running simulations comes from NOT
running them: when a trained GP surrogate is trustworthy at a task's
input theta, the scheduler can serve the task from the surrogate
(milliseconds) instead of the forward model (minutes to hours).  PR 1/2
built the dispatch layers that *predict* runtimes; this module makes
them *act* on the surrogate option:

  * `SurrogateOffload` — the decision engine + surrogate server.  A task
    is offloaded when BOTH gates pass:
      1. cost gate: the predicted runtime (online predictor, else the
         HQ-style `time_request` hint) exceeds `runtime_budget_s` —
         short tasks are cheaper to just run;
      2. trust gate: the STANDARDISED (latent) GP posterior sd at theta
         is at most `sd_threshold`.  The outputs share one kernel, so
         the latent sd is common to all columns; being dimensionless,
         one threshold spans growth rate and mode frequency despite
         their ~100x scale split.  (Per-output variance in original
         units — the PR's bugfix — is what `gp.predict` reports and
         what original-scale consumers like `uq.adaptive` gate on.)
    Trust scoring runs through `gp.predict_batch` — the bucket-padded
    batched predict (Pallas kernel on TPU) — so routing a large queue
    costs a few fixed-shape launches, not one fresh XLA compile per
    queue length.  Completed REAL runs are fed back via `observe`, which
    conditions the posterior so nearby thetas become offloadable.
  * `SurrogateOffloadPolicy` — a `SchedulingPolicy` (registered as
    ``policy="offload"``) wrapping any inner policy: offloaded tasks go
    to a fast FIFO served before the inner queue (they cost
    milliseconds; draining them first frees dependents sooner), the
    rest to the wrapped policy.  The cluster-level counterpart lives in
    `repro_torch.cluster.Broker` (``surrogate=``), which models the surrogate
    as a zero-queue-wait virtual allocation.

The offload decision is re-made on every push (requeues and migrations
re-decide with fresher predictor/posterior state); the chosen path is
recorded in ``req.config["_surrogate"]`` so the executor and the
discrete-event simulator serve the same routing.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import TYPE_CHECKING, Any, Deque, List, Optional, Sequence

import numpy as np

from repro_torch.sched.policy import QueueItem, SchedulingPolicy, WorkerView
from repro_torch.sched.predictor import flatten_parameters, request_features
from repro_torch.sched.registry import make_policy, register_policy

if TYPE_CHECKING:                              # hint-only: keeps repro_torch.sched
    from repro_torch.core.task import EvalRequest    # import-cycle-free

SURROGATE_KEY = "_surrogate"                   # config flag: serve via GP
NO_SURROGATE_KEY = "_no_surrogate"             # config flag: pin to real path


class SurrogateOffload:
    """Decision engine + surrogate evaluator shared by every dispatch
    layer (single-node policy, cluster broker, live executor, simulator).

    `posterior` is a trained `repro_torch.uq.gp.GPPosterior` over the task
    input theta (or an already-configured `repro_torch.uq.engine` backend);
    None (or fewer than `min_train` training points) keeps every task on
    the real path — an unarmed engine is a no-op router.  `backend`
    selects the surrogate engine a bare posterior is lifted into:
    "exact" (default, full refit per conditioning — the reference),
    "incremental" (O(n²) block Cholesky updates on the completion
    stream) or "partitioned" (cap-bounded local-GP ensemble).

    Thread-safety: decisions run under the executor's dispatch lock,
    `evaluate`/`observe` from worker threads; the internal lock guards
    the engine swap and the counters.  A push-time trust check costs
    one bucketed (pre-compiled) predict launch; the compile itself is
    warmed at construction and after each conditioning, OFF the dispatch
    lock, so the pool never stalls on XLA.
    """

    def __init__(self, posterior=None, *, model_name: Optional[str] = None,
                 runtime_budget_s: float = 60.0,
                 sd_threshold: float = 0.1, min_train: int = 8,
                 latency_s: float = 0.05, n_virtual_workers: int = 1,
                 condition_every: int = 8, max_points: int = 256,
                 sd_window: int = 4096, backend: str = "exact",
                 drift_disable_s: float = 300.0,
                 **backend_kw):
        from repro_torch.uq import engine as uq_engine
        self.backend = backend
        # backend-specific knobs (e.g. partitioned's expert_cap,
        # incremental's refactor_every) ride through to the engine —
        # both here and on every posterior re-arm
        self._backend_kw = backend_kw
        self._engine = uq_engine.as_engine(posterior, backend,
                                           max_points=max_points,
                                           **backend_kw)
        # which model this surrogate stands in for; None means "any" —
        # only safe when every model shares the posterior's theta space.
        # With several models whose payloads happen to flatten to the
        # same dimension, an unscoped engine would serve model B from a
        # surrogate of model A (and condition it on B's values), so
        # multi-model executors should always scope the engine.
        self.model_name = model_name
        self.runtime_budget_s = runtime_budget_s
        self.sd_threshold = sd_threshold
        self.min_train = min_train
        # what one surrogate evaluation costs (the simulator's virtual
        # runtime; the live path measures the real predict instead)
        self.latency_s = latency_s
        self.n_virtual_workers = n_virtual_workers
        self.condition_every = condition_every
        # optional repro_torch.obs.Tracer: decide() emits an `offload.decide`
        # instant per decision (set by Broker.set_tracer / the executor)
        self.tracer = None
        # degraded state: while set, every decision is "real path" —
        # armed by a surrogate outage fault or a calib.drift alarm
        # (`note_drift_alarm`), re-armed by `tick_degraded` once the
        # cool-down passes (the stepper ticks it each step)
        self.degraded_until: Optional[float] = None
        self.degraded_reason: Optional[str] = None
        self.drift_disable_s = float(drift_disable_s)
        # recency cap on the conditioned training set (mirrors
        # GPRuntimePredictor.max_points): without it every batch of
        # completions grows N forever — O(N^3) Cholesky rebuilds and a
        # fresh predict compile per size, on the _complete path
        self.max_points = max_points
        self._lock = threading.Lock()
        self.n_considered = 0
        self.n_offloaded = 0
        self.n_evals = 0
        self.cpu_seconds_avoided = 0.0
        # most recent trust-check sds only: bounded memory, and stats()
        # (called under the engine lock) stays O(window), not O(run)
        self._sds: Deque[float] = deque(maxlen=sd_window)
        self._pend_x: List[List[float]] = []   # buffered conditioning batch
        self._pend_y: List[List[float]] = []
        # trust checks run at push time under the executor's dispatch
        # lock; pre-compiling the single-theta bucket shape here keeps
        # the first decide() from stalling the whole pool on an XLA
        # compile (each conditioning re-warms its new training size)
        self._warm(self._engine)

    @property
    def posterior(self):
        """The underlying `GPPosterior` (exact/incremental engines), the
        engine itself (partitioned — there is no single factor), or None
        when unarmed.  Assignment re-arms the router: a bare posterior is
        lifted into this engine's configured backend."""
        eng = self._engine
        return getattr(eng, "post", eng)

    @property
    def device(self):
        """Where the armed engine's tensors live (None when unarmed)."""
        return None if self._engine is None else self._engine.device

    @posterior.setter
    def posterior(self, post) -> None:
        from repro_torch.uq import engine as uq_engine
        self._engine = uq_engine.as_engine(post, self.backend,
                                           max_points=self.max_points,
                                           **self._backend_kw)

    @staticmethod
    def _warm(eng) -> None:
        if eng is not None:
            eng.warm()

    # -- trust scoring ---------------------------------------------------
    def trust_sd(self, thetas: Sequence[Sequence[float]]) -> np.ndarray:
        """Standardised (latent) posterior sd at each theta — one
        bucket-padded `predict_batch` pass through the engine for the
        whole batch.

        The outputs share one kernel, so the latent sd is the same for
        every column; dividing any column's original-scale sd by its own
        y_std recovers it.  Being dimensionless, one `sd_threshold`
        spans outputs of any physical scale (growth rate vs frequency)."""
        return self._engine.latent_sd(thetas)

    # -- routing decision ------------------------------------------------
    def decide(self, req: "EvalRequest", cost: Optional[float]) -> bool:
        """True -> serve `req` from the surrogate.  Also stamps/clears
        ``req.config["_surrogate"]`` so runners see the same routing.
        ``req.config["_no_surrogate"]`` pins a task to the real path
        (set after a surrogate failure, and by straggler speculation —
        a speculated copy must duplicate the SAME work)."""
        offload = self._decide(req, cost)
        if not offload:
            # a "no" for a task credited on an earlier attempt (requeue
            # after a crash, trust since lost) refunds that credit: the
            # task will burn real CPU after all
            self.rollback(req)
        if self.tracer is not None:
            self.tracer.instant("offload.decide",
                                args={"task": req.task_id,
                                      "offload": bool(offload)})
        return offload

    def _decide(self, req: "EvalRequest", cost: Optional[float]) -> bool:
        req.config.pop(SURROGATE_KEY, None)
        with self._lock:
            self.n_considered += 1
            eng = self._engine
        if req.config.get(NO_SURROGATE_KEY):
            return False                       # pinned to the real path
        if self.degraded_until is not None:
            return False                       # outage / drift cool-down
        if self.model_name is not None and \
                req.model_name != self.model_name:
            return False                       # not this surrogate's model
        if not cost or cost < self.runtime_budget_s:
            return False                       # cheap enough to just run
        if eng is None or eng.n_train() < self.min_train:
            return False                       # no (trained) surrogate yet
        theta = request_features(req)          # flattened once per request
        if theta is None or len(theta) != eng.dim():
            return False                       # not in the surrogate's space
        sd = float(self.trust_sd([theta])[0])
        avoided = max(float(cost) - self.latency_s, 0.0)
        with self._lock:
            self._sds.append(sd)
            if sd > self.sd_threshold:
                return False                   # not trusted at this theta
            # one credit per TASK, not per decision: a requeued attempt
            # (crash, injected failure) re-decides but must not double
            # the offload count or the avoided-CPU credit
            if req.config.get("_surrogate_credit") is None:
                self.n_offloaded += 1
                self.cpu_seconds_avoided += avoided
                req.config["_surrogate_credit"] = avoided
        req.config[SURROGATE_KEY] = True
        return True

    def rollback(self, req: "EvalRequest") -> None:
        """Un-credit an offload that will not happen after all (failed
        surrogate evaluation, trust lost on a requeue): no-op unless this
        task holds a credit."""
        credit = req.config.pop("_surrogate_credit", None)
        if credit is None:
            return
        with self._lock:
            self.n_offloaded -= 1
            self.cpu_seconds_avoided -= credit

    def note_served(self) -> None:
        """Count one served surrogate evaluation (the simulator calls
        this where the live path counts inside `evaluate`)."""
        with self._lock:
            self.n_evals += 1

    # -- degradation (outage faults, drift alarms) -----------------------
    def set_degraded(self, now: float, until: float,
                     reason: str = "outage") -> None:
        """Disable offload until ``until`` (every `_decide` answers
        "real path").  Emits one ``offload.degraded`` instant on the
        healthy->degraded edge; an extension while already degraded
        just moves the deadline."""
        with self._lock:
            was_healthy = self.degraded_until is None
            self.degraded_until = float(until)
            self.degraded_reason = str(reason)
        if was_healthy and self.tracer is not None:
            self.tracer.instant("offload.degraded", ts=now,
                                args={"degraded": True, "reason": reason})

    def tick_degraded(self, now: float) -> None:
        """Re-arm once the cool-down has passed (called from
        `LifecycleStepper.step`, so sim and live re-arm at the same
        virtual instant)."""
        with self._lock:
            until = self.degraded_until
            if until is None or now < until:
                return
            reason = self.degraded_reason
            self.degraded_until = None
            self.degraded_reason = None
        if self.tracer is not None:
            self.tracer.instant("offload.degraded", ts=now,
                                args={"degraded": False, "reason": reason})

    def note_drift_alarm(self, alarm: Any, now: float) -> None:
        """`CalibrationMonitor.on_alarm` adapter: a drifting cost model
        means the offload economics (and trust region) are suspect —
        cool off for `drift_disable_s` seconds."""
        phase = (alarm or {}).get("phase", "?")
        self.set_degraded(now, now + self.drift_disable_s,
                          reason=f"drift:{phase}")

    # -- surrogate serving ----------------------------------------------
    def evaluate(self, parameters) -> List[List[float]]:
        """Serve one offloaded task: the GP posterior mean at theta, in
        UM-Bridge output shape ([[...]])."""
        theta = flatten_parameters(parameters)
        if theta is None:
            raise ValueError(f"unflattenable parameters {parameters!r}")
        with self._lock:
            eng = self._engine
        mean, _ = eng.predict_batch(np.asarray([theta], np.float32))
        out = [[float(v) for v in mean.cpu().numpy()[0]]]
        self.note_served()                     # only ANSWERED evals count
        return out

    def observe(self, parameters, value,
                model_name: Optional[str] = None) -> None:
        """Feed one completed REAL run; the engine is conditioned in
        batches of `condition_every` (every conditioning costs at least a
        fresh predict shape — amortise it; what the conditioning itself
        costs is the engine backend's contract: a full O(n³) refit on
        "exact", an O(n²) block update on "incremental", an O(cap³)
        per-affected-expert refactor on "partitioned").  Scoped engines
        ignore other models' completions — conditioning the surrogate on
        a different model's values would shrink variance on garbage."""
        if self.model_name is not None and model_name is not None \
                and model_name != self.model_name:
            return
        theta = flatten_parameters(parameters)
        if theta is None:
            return
        y = flatten_parameters(value)
        if y is None:
            return
        with self._lock:
            eng = self._engine
            if eng is None or len(theta) != eng.dim():
                return
            if len(y) != eng.n_outputs():
                return
            self._pend_x.append(theta)
            self._pend_y.append(y)
            if len(self._pend_x) < self.condition_every:
                return
            xs, ys = self._pend_x, self._pend_y
            self._pend_x, self._pend_y = [], []
        # conditioning (and the recency cap, owned by the engine) runs
        # outside the lock; engines are persistent so readers racing this
        # update keep a consistent snapshot
        new_engine = eng.condition(np.asarray(xs, np.float32),
                                   np.asarray(ys, np.float32))
        self._warm(new_engine)                 # compile off the hot path
        with self._lock:
            if self._engine is eng:
                self._engine = new_engine
            else:
                # lost a conditioning race (or a re-arm): the batch is
                # real ground truth — requeue it rather than dropping it
                self._pend_x.extend(xs)
                self._pend_y.extend(ys)

    # -- introspection ---------------------------------------------------
    def stats(self):
        """Snapshot as a `repro_torch.core.metrics.OffloadStats` (imported
        lazily: repro_torch.core depends on repro_torch.sched, not vice versa)."""
        from repro_torch.core import metrics as _metrics
        with self._lock:
            return _metrics.OffloadStats(
                n_considered=self.n_considered,
                n_offloaded=self.n_offloaded,
                n_surrogate_evals=self.n_evals,
                cpu_seconds_avoided=self.cpu_seconds_avoided,
                sd_histogram=_metrics.sd_histogram(self._sds))


def record_decisions(offload) -> dict:
    """Log every routing decision of `offload` (this package's
    `SurrogateOffload` or any object with its `trust_sd` / `decide`):
    returns a dict, filled as the run goes, of task id -> (trust sd, or
    None where a gate answered before the trust check; the decision).
    Two runs' logs compare their routing task by task."""
    log, trust_sd, decide = {}, offload.trust_sd, offload.decide

    def logged_trust_sd(thetas):
        sds = trust_sd(thetas)
        log["_sd"] = float(sds[0])
        return sds

    def logged_decide(req, cost):
        log.pop("_sd", None)
        out = decide(req, cost)
        log[req.task_id] = (log.pop("_sd", None), bool(out))
        return out

    offload.trust_sd, offload.decide = logged_trust_sd, logged_decide
    return log


@register_policy("offload")
class SurrogateOffloadPolicy(SchedulingPolicy):
    """Single-node surrogate-offload routing around any inner policy.

    Offloaded tasks land in a FIFO fast lane popped before the inner
    queue; everything else flows through the wrapped policy unchanged.
    Construct with a configured `SurrogateOffload` (``surrogate=``); the
    name-registered default builds an unarmed engine, i.e. plain
    pass-through to the inner policy until a posterior is attached.
    """

    name = "offload"

    def __init__(self, predictor=None, policy: Any = "fcfs",
                 surrogate: Optional[SurrogateOffload] = None):
        super().__init__(predictor)
        if isinstance(policy, SchedulingPolicy):
            raise TypeError(
                "SurrogateOffloadPolicy wraps a fresh inner policy: pass "
                "a registered name or factory, not a shared instance")
        self.surrogate = surrogate if surrogate is not None \
            else SurrogateOffload()
        self._inner = make_policy(policy, predictor)
        self._fast: Deque[QueueItem] = deque()

    def bind(self, predictor) -> "SurrogateOffloadPolicy":
        super().bind(predictor)
        self._inner.bind(self.predictor)
        return self

    def push(self, req, attempt):
        if self.surrogate.decide(req, cost=self.cost(req)):
            self._fast.append((req, attempt))
        else:
            self._inner.push(req, attempt)

    def pop(self, worker: Optional[WorkerView] = None
            ) -> Optional[QueueItem]:
        if self._fast:
            return self._fast.popleft()
        return self._inner.pop(worker)

    def pending(self) -> List[QueueItem]:
        return list(self._fast) + self._inner.pending()

    def __len__(self) -> int:
        return len(self._fast) + len(self._inner)

    def remove_worker(self, wid: int) -> None:
        self._inner.remove_worker(wid)
