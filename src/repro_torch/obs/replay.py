"""Trace replay: reconstruct a recorded run's workload and overheads.

`repro_torch.obs.calib` fits *distributions* from a trace; this module goes
one step further and replays the *specific run*: the recorded arrivals
become a `TraceTask` list, the recorded per-task compute seconds become
the replay runtimes, and the recorded overhead draws (queue waits, cold
inits, dispatch latency) become a `ReplayBackendSpec` — a drop-in
`BackendSpec` whose `draw_queue_wait` pops the recorded values in
submission order (FIFO) instead of sampling.

The exactness contract (asserted in `tests/test_calib.py`): a trace
recorded by a seeded `simulate_cluster` run, replayed through
`simulate_cluster` with the same configuration and `replay.spec(base)`,
reproduces the original per-task records and makespan EXACTLY — bitwise,
not approximately.  That works because the sim's only randomness is the
queue-wait draws (replayed FIFO from the exact values recorded in
``alloc.queued`` args, including draws of allocations later cancelled
while queued), and every other overhead is a spec constant recorded
exactly by the ``trace.spec`` instant (span durations are endpoint
differences and lose the last ulp; the args route does not).

For traces that did not capture a task's runtime — killed-terminal tasks
never completed an attempt, lost tasks never started one — the replay
substitutes: ``inf`` for killed tasks (a task that outlives every
allocation it is given is killed on the same attempt schedule as the
original; a finite guess could let it finish early and change the run),
and prior / per-model median / time_request / `default_runtime` for lost
tasks (whose runtime cannot influence a faithful replay anyway — a task
the original run never served is never served by the replay either).

Live traces replay the same way, just without the bitwise guarantee:
the live executor's overheads are wall-clock facts, so the replayed sim
is the *model under test* — `benchmarks/calibration.py` compares its
phase attribution against the live trace's, before and after
calibration.  Surrogate-offloaded attempts are replayed as real runs of
their recorded compute (the offload decision itself is policy state the
trace does not carry).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from collections import deque
from typing import Any, Deque, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.backends import BackendSpec
from repro_torch.cluster.traces import TraceTask
from repro_torch.obs.trace import TraceEvent, read_jsonl


@dataclasses.dataclass(frozen=True)
class ReplayBackendSpec(BackendSpec):
    """A `BackendSpec` that replays recorded overheads.

    `draw_queue_wait` pops the recorded queue waits in submission order
    (falling back to the base parametric draw when the recording runs
    dry — e.g. a replay configured to submit more allocations than the
    original run did); `queue_wait_median` stays the base model, so
    autoalloc cost scoring is unchanged.  `server_init_for` answers the
    per-model recorded cold-init cost.  Scalar `dispatch_latency` /
    `server_init` / `queue_wait_sigma` fields carry the originating
    spec's exact constants when the trace recorded a ``trace.spec``
    instant (sim and parity traces do), else medians of the observed
    spans.  Build instances via `TraceReplay.spec` — each call gets a
    fresh FIFO, so one recording can feed many replays.
    """
    queue_fifo: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)
    init_by_model: Mapping[str, float] = \
        dataclasses.field(default_factory=dict, compare=False, repr=False)
    replayed_from: str = ""

    def draw_queue_wait(self, rng, alloc_request_s: float,
                        n_cpus: int = 1) -> float:
        if self.queue_fifo:
            return self.queue_fifo.popleft()
        return super().draw_queue_wait(rng, alloc_request_s, n_cpus)

    def server_init_for(self, model: str) -> float:
        return self.init_by_model.get(model, self.server_init)


class TraceReplay:
    """Parsed form of one recorded trace, ready to re-run.

    Parameters
    ----------
    events:          `TraceEvent` tuples (a `Tracer.events()` list or
                     `read_jsonl` output).
    priors:          optional ``{model: runtime_seconds}`` analytical
                     priors (e.g. `repro_torch.obs.calib.hlo_runtime_prior`
                     over a cost analysis) used for tasks the trace never
                     timed.
    default_runtime: last-resort runtime for an untimed task of an
                     unobserved model with no prior and no time_request.
    """

    def __init__(self, events: Sequence[TraceEvent], *,
                 priors: Optional[Mapping[str, float]] = None,
                 default_runtime: float = 1.0,
                 label: str = "trace"):
        self.priors = dict(priors or {})
        self.default_runtime = float(default_runtime)
        self.label = label
        self.meta: Dict[str, Any] = {}
        # arrival-order reconstruction state
        self._arrivals: List[Dict[str, Any]] = []     # attempt-1 queued args
        self._runtimes: Dict[Any, float] = {}         # task -> compute
        self._model_of: Dict[Any, str] = {}
        self._killed: set = set()
        self._completed: set = set()
        self.queue_waits: List[float] = []            # submission order
        self._init_samples: Dict[str, List[float]] = {}
        self._dispatch_samples: List[float] = []
        self._parse(events)

    @classmethod
    def from_jsonl(cls, path: str, **kw) -> "TraceReplay":
        kw.setdefault("label", path)
        return cls(read_jsonl(path), **kw)

    # ------------------------------------------------------------------
    def _parse(self, events: Sequence[TraceEvent]) -> None:
        for ts, ph, name, pid, tid, dur, args in events:
            a = args or {}
            if ph == "i":
                if name == "trace.spec":
                    self.meta = dict(a)
                elif name == "task.queued" and a.get("attempt", 1) == 1:
                    row = dict(a)
                    row["t"] = ts
                    self._arrivals.append(row)
                    if "model" in a:
                        self._model_of[a.get("task")] = a["model"]
                elif name == "task.killed":
                    self._killed.add(a.get("task"))
            elif ph == "X":
                if name == "task.run":
                    if a.get("status", "ok") == "ok":
                        tid_ = a.get("task")
                        self._runtimes[tid_] = a.get("compute", dur)
                        self._completed.add(tid_)
                        if "model" in a:
                            self._model_of.setdefault(tid_, a["model"])
                elif name == "task.init":
                    model = a.get("model")
                    if model is not None:
                        self._init_samples.setdefault(model, []).append(
                            a.get("init", dur))
                elif name == "task.dispatch":
                    self._dispatch_samples.append(dur)
            elif ph == "B" and name == "alloc.queued" \
                    and not a.get("virtual") and "queue_wait" in a:
                self.queue_waits.append(float(a["queue_wait"]))

    # ------------------------------------------------------------------
    def runtime_of(self, task: Any) -> float:
        """The replay runtime for one recorded task (see module doc for
        the untimed-task substitution ladder)."""
        rt = self._runtimes.get(task)
        if rt is not None:
            return rt
        if task in self._killed:
            return math.inf
        model = self._model_of.get(task)
        if model in self.priors:
            return float(self.priors[model])
        timed = [v for t, v in self._runtimes.items()
                 if self._model_of.get(t) == model and math.isfinite(v)]
        if timed:
            return float(statistics.median(timed))
        row = next((r for r in self._arrivals if r.get("task") == task),
                   None)
        if row is not None and row.get("time_request") is not None:
            return float(row["time_request"])
        return self.default_runtime

    def trace(self) -> List[TraceTask]:
        """The recorded workload as a `TraceTask` list, in arrival order
        (so `trace_requests` re-derives the original task indexing)."""
        out: List[TraceTask] = []
        for row in self._arrivals:
            out.append(TraceTask(
                t=float(row["t"]),
                runtime=self.runtime_of(row.get("task")),
                model_name=row.get("model", "model"),
                time_request=row.get("time_request"),
                n_cpus=int(row.get("n_cpus", 1)),
                parameters=row.get("parameters"),
                tenant=row.get("tenant", "default")))
        return out

    def spec(self, base: BackendSpec) -> ReplayBackendSpec:
        """A fresh replay spec over `base` (fresh queue-wait FIFO per
        call): exact recorded constants where the trace has them, base
        values elsewhere."""
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(BackendSpec)}
        if "dispatch_latency" in self.meta:
            fields["dispatch_latency"] = float(self.meta["dispatch_latency"])
        elif self._dispatch_samples:
            fields["dispatch_latency"] = \
                float(statistics.median(self._dispatch_samples))
        init_by_model = {m: float(statistics.median(v))
                         for m, v in self._init_samples.items() if v}
        if "server_init" in self.meta:
            fields["server_init"] = float(self.meta["server_init"])
        elif init_by_model:
            fields["server_init"] = \
                float(statistics.median(list(init_by_model.values())))
        if "queue_wait_sigma" in self.meta:
            fields["queue_wait_sigma"] = float(self.meta["queue_wait_sigma"])
        fields["name"] = f"{base.name}+replay"
        fifo: Deque[float] = deque(self.queue_waits)
        return ReplayBackendSpec(queue_fifo=fifo,
                                 init_by_model=init_by_model,
                                 replayed_from=self.label, **fields)

    def summary(self) -> Dict[str, Any]:
        return {"n_tasks": len(self._arrivals),
                "n_timed": len(self._runtimes),
                "n_killed": len(self._killed),
                "n_queue_waits": len(self.queue_waits),
                "has_spec_meta": bool(self.meta),
                "models": sorted({r.get("model", "model")
                                  for r in self._arrivals})}


def replay_cluster(base_spec: BackendSpec, source: Any, **sim_kw):
    """One-call replay: parse `source` (JSONL path, event list, or a
    `TraceReplay`) and run it through `simulate_cluster` over
    `base_spec` with the recorded workload and overhead draws."""
    from repro_torch.cluster.sim import simulate_cluster
    if isinstance(source, TraceReplay):
        replay = source
    elif isinstance(source, str):
        replay = TraceReplay.from_jsonl(source)
    else:
        replay = TraceReplay(source)
    return simulate_cluster(replay.spec(base_spec), replay.trace(),
                            **sim_kw)
