"""UM-Bridge model protocol and evaluation-request types.

The paper's abstraction: a model is a map F: R^n -> R^m, served behind a
language-agnostic interface; the UQ client sends evaluation requests
{F(theta_i)} and the load balancer distributes them.  Here the HTTP layer
is replaced by in-process calls (documented assumption change in
DESIGN.md) but the protocol surface is kept: models declare input/output
sizes, are queried for readiness before first use, and may expose a cost
hint (the analogue of HQ's per-job *time request* — a scheduling hint,
distinct from the *time limit* safety bound).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

_task_counter = itertools.count()

# Tenant every request belongs to unless it says otherwise.  Single-owner
# deployments never see any other value.
DEFAULT_TENANT = "default"


class Model:
    """Base class mirroring umbridge.Model."""

    def __init__(self, name: str):
        self.name = name

    def get_input_sizes(self, config: Optional[Dict] = None) -> List[int]:
        raise NotImplementedError

    def get_output_sizes(self, config: Optional[Dict] = None) -> List[int]:
        raise NotImplementedError

    def __call__(self, parameters: Sequence[Sequence[float]],
                 config: Optional[Dict] = None) -> List[List[float]]:
        raise NotImplementedError

    def supports_evaluate(self) -> bool:
        return True

    # --- scheduling extensions (this paper) ---------------------------
    def cost_hint(self, parameters, config: Optional[Dict] = None
                  ) -> Optional[float]:
        """Expected compute seconds (HQ 'time request' analogue); None if
        unpredictable — the GS2 case the paper is built around."""
        return None

    def warmup(self) -> None:
        """Server initialisation (compile caches etc.).  The ~1 s per-job
        model-server init the paper measures corresponds to this running
        per job on the naive backend vs once per worker on HQ."""


@dataclasses.dataclass
class LambdaModel(Model):
    """Wrap a plain callable as a Model."""

    def __init__(self, name: str, fn: Callable, input_size: int,
                 output_size: int, cost_fn: Optional[Callable] = None,
                 warmup_fn: Optional[Callable] = None):
        super().__init__(name)
        self._fn = fn
        self._in = input_size
        self._out = output_size
        self._cost_fn = cost_fn
        self._warmup_fn = warmup_fn

    def get_input_sizes(self, config=None):
        return [self._in]

    def get_output_sizes(self, config=None):
        return [self._out]

    def __call__(self, parameters, config=None):
        return self._fn(parameters, config)

    def cost_hint(self, parameters, config=None):
        return self._cost_fn(parameters, config) if self._cost_fn else None

    def warmup(self):
        if self._warmup_fn:
            self._warmup_fn()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Hardened requeue semantics for one request (repro_torch.chaos).

    Requeues after a *fatal* attempt (worker crash, corrupted result) are
    released ``backoff_s`` seconds later instead of immediately, with
    exponential growth per attempt and a deterministic seeded jitter —
    ``backoff_s(task_id, attempt, seed)`` is a pure function, so the sim
    and the live replay compute byte-identical release times (pinned by
    the parity suite).  ``quarantine_after`` caps fatal failures: once a
    task has killed that many workers it is quarantined (terminal
    ``quarantined`` record) instead of crash-looping forever.

    The default-constructed policy (all zeros, no quarantine) is
    semantically identical to ``retry=None`` for timing, so traces stamped
    with it stay comparable to legacy runs.
    """
    base_s: float = 0.0              # first-retry backoff (0 = immediate)
    factor: float = 2.0              # exponential growth per attempt
    max_s: float = 60.0              # backoff ceiling
    jitter: float = 0.0              # +/- fraction of the backoff, seeded
    quarantine_after: Optional[int] = None   # fatal failures before terminal

    def backoff_s(self, task_id: str, attempt: int, seed: int = 0) -> float:
        """Deterministic backoff before re-releasing `attempt`'s requeue.

        The jitter draw hashes (seed, task_id, attempt) — not global RNG
        state — so any driver, in any completion order, on any host,
        computes the same delay."""
        if self.base_s <= 0.0:
            return 0.0
        raw = self.base_s * (self.factor ** max(attempt - 1, 0))
        delay = min(raw, self.max_s)
        if self.jitter > 0.0:
            digest = hashlib.blake2b(
                f"{seed}:{task_id}:{attempt}".encode(),
                digest_size=8).digest()
            u = int.from_bytes(digest, "big") / 2.0 ** 64   # [0, 1)
            delay *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(delay, 0.0)


@dataclasses.dataclass
class EvalRequest:
    """One F(theta) evaluation travelling through the load balancer."""
    model_name: str
    parameters: Any
    config: Dict = dataclasses.field(default_factory=dict)
    # HQ-style scheduling fields (seconds):
    time_request: Optional[float] = None     # expected runtime (hint)
    time_limit: Optional[float] = None       # hard kill bound
    n_cpus: int = 1
    task_id: str = ""
    submit_t: float = 0.0
    max_attempts: int = 3
    # dependency edges (MCMC-style chains): ids that must finish first
    depends_on: Sequence[str] = ()
    # absolute completion deadline on the scheduler's clock (drives the
    # "edf" policy; None = no SLO, sorts after every deadlined task)
    deadline: Optional[float] = None
    # owning tenant (multi-tenant broker service); the default tenant
    # keeps every single-owner code path byte-for-byte identical —
    # fair-share scheduling, quotas, and per-tenant SLO accounting only
    # engage when requests carry distinct tenants
    tenant: str = DEFAULT_TENANT
    # hardened requeue semantics (None = legacy immediate requeue); a
    # plain dict (journal round trip) is rehydrated into a RetryPolicy
    retry: Optional[Any] = None

    def __post_init__(self):
        if not self.task_id:
            self.task_id = f"task-{next(_task_counter)}"
        if isinstance(self.retry, dict):
            self.retry = RetryPolicy(**self.retry)
        # submit_t is stamped by whoever owns the clock: `Executor.submit`
        # (its injected clock) or the simulator (trace arrival time).  A
        # wall-clock default here would leak `time.monotonic` into
        # virtual-clock parity replays.


@dataclasses.dataclass
class EvalResult:
    task_id: str
    value: Any = None
    status: str = "ok"            # ok | failed | timeout | quarantined
    error: Optional[str] = None
    worker: str = ""
    attempts: int = 1
    submit_t: float = 0.0
    dispatch_t: float = 0.0
    start_t: float = 0.0
    end_t: float = 0.0
    compute_t: float = 0.0                    # pure application time
    init_t: float = 0.0                       # server-init share

    @property
    def cpu_time(self) -> float:
        return self.init_t + self.compute_t

    @property
    def queue_wait(self) -> float:
        return max(self.start_t - self.submit_t, 0.0)
