"""UM-Bridge load balancer for the live executor.

The paper's C++ load balancer sits between UQ clients and model servers:
it registers servers, runs readiness checks (the 'at least five additional
jobs' of §V that verify input/output dimensions before the first real
evaluation), health-checks them periodically, and routes requests
first-come-first-served, spawning servers on demand through a scheduling
backend (SLURM or HQ).

Here the backend choice maps onto the Executor's two server-lifecycle
modes, and the readiness/health machinery is kept verbatim in spirit:
registration probes really do instantiate a server and compare declared
vs. observed dimensions, and health checks really do round-trip a probe
evaluation through the scheduler.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.executor import Executor
from repro_torch.core.metrics import TaskRecord
from repro_torch.core.task import EvalRequest, EvalResult, Model

READINESS_PROBES = 5                 # paper §V: preliminary verification jobs


@dataclasses.dataclass
class ModelInfo:
    name: str
    input_sizes: List[int]
    output_sizes: List[int]
    registered_t: float
    probes_run: int = 0
    healthy: bool = True
    last_health_t: float = 0.0


class LoadBalancer:
    """Language-agnostic facade: register models, evaluate through the
    scheduler, monitor health."""

    def __init__(self, backend: str = "hq", n_workers: int = 2, *,
                 policy: Any = "fcfs", predictor: Any = None,
                 cluster: Any = None, autoalloc: Any = None,
                 **executor_kw):
        """`policy` / `predictor` select the `repro_torch.sched` scheduling
        policy and online runtime predictor by registered name (or
        instance); `cluster` / `autoalloc` hand over a `repro_torch.cluster`
        `Broker` / `AutoAllocConfig` for allocation-backed elasticity.
        All four pass straight through to the `Executor` — e.g.
        ``LoadBalancer("hq", policy="pack", predictor="gp",
        autoalloc=AutoAllocConfig(walltime_s=600))``."""
        assert backend in ("hq", "slurm"), backend
        self.backend = backend
        self._factories: Dict[str, Callable[[], Model]] = {}
        self._info: Dict[str, ModelInfo] = {}
        self._executor_kw = dict(executor_kw)
        self._executor_kw.setdefault("persistent_servers", backend == "hq")
        # honour an injected clock (virtual-time replays): the balancer's
        # own timestamps (registration, health checks) must come off the
        # same clock as the executor's, or parity traces mix time bases
        self._clock: Callable[[], float] = \
            self._executor_kw.get("clock") or time.monotonic
        self._executor_kw["policy"] = policy
        self._executor_kw["predictor"] = predictor
        if cluster is not None:
            self._executor_kw["cluster"] = cluster
        if autoalloc is not None:
            self._executor_kw["autoalloc"] = autoalloc
        self._n_workers = n_workers
        self.executor: Optional[Executor] = None

    @property
    def policy(self):
        """The live scheduling-policy object (None before start())."""
        return self.executor.policy if self.executor else None

    @property
    def predictor(self):
        """The live runtime predictor (None before start() / if unset)."""
        return self.executor.predictor if self.executor else None

    # ------------------------------------------------------------------
    def register_model(self, name: str, factory: Callable[[], Model],
                       verify: bool = True) -> ModelInfo:
        """Register a model server factory; run the readiness probes the
        paper describes (instantiate, query dims, compare declared)."""
        self._factories[name] = factory
        probe = factory()
        ins = probe.get_input_sizes()
        outs = probe.get_output_sizes()
        info = ModelInfo(name=name, input_sizes=ins, output_sizes=outs,
                         registered_t=self._clock())
        if verify:
            for _ in range(READINESS_PROBES):
                i2 = probe.get_input_sizes()
                o2 = probe.get_output_sizes()
                if i2 != ins or o2 != outs:
                    raise RuntimeError(
                        f"model {name!r} readiness check failed: "
                        f"dims changed {ins}/{outs} -> {i2}/{o2}")
                info.probes_run += 1
        self._info[name] = info
        if self.executor is not None:
            self.executor.model_factories[name] = factory
        return info

    def start(self) -> "LoadBalancer":
        if self.executor is None:
            self.executor = Executor(self._factories, self._n_workers,
                                     name=self.backend, **self._executor_kw)
        return self

    # ------------------------------------------------------------------
    def submit(self, req: EvalRequest) -> str:
        assert self.executor is not None, "call start() first"
        if req.model_name not in self._factories:
            raise KeyError(f"unregistered model {req.model_name!r}")
        return self.executor.submit(req)

    def evaluate(self, model_name: str, parameters, config=None,
                 timeout: float = 300.0):
        self.start()
        return self.executor.evaluate(model_name, parameters, config,
                                      timeout)

    def run_all(self, reqs: Sequence[EvalRequest], timeout: float = 600.0
                ) -> List[EvalResult]:
        self.start()
        return self.executor.run_all(reqs, timeout)

    # ------------------------------------------------------------------
    def health_check(self, model_name: str, probe_parameters,
                     timeout: float = 60.0) -> bool:
        """Round-trip a probe evaluation through the scheduler; mark the
        model unhealthy on failure (the balancer's periodic monitor)."""
        info = self._info[model_name]
        try:
            self.evaluate(model_name, probe_parameters, timeout=timeout)
            info.healthy = True
        except Exception:  # noqa: BLE001
            info.healthy = False
        info.last_health_t = self._clock()
        return info.healthy

    def models(self) -> Dict[str, ModelInfo]:
        return dict(self._info)

    def records(self) -> List[TaskRecord]:
        return self.executor.records() if self.executor else []

    def shutdown(self):
        if self.executor is not None:
            self.executor.shutdown()
            self.executor = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
