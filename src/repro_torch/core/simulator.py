"""Deterministic discrete-event cluster simulator.

Reproduces the paper's scheduler-comparison experiments (Figs. 3, 4, 5, 6)
quantitatively: 100 evaluations per benchmark, a fixed number of jobs
(2 or 10) kept in flight — "mimicking a user submitting jobs one after the
other up to a predefined threshold" — on either a naive-SLURM, UM-Bridge-
SLURM, or HQ backend spec.

Queue waits on the shared Hamilton8 cluster are irreproducible wall-clock
facts; they are modelled as seeded lognormal delays whose medians scale
with the requested allocation time (longer requests queue longer), with
constants calibrated so the paper's headline numbers emerge:
  * >= 3 orders of magnitude lower median per-job scheduling overhead (HQ),
  * ~38 % lower GS2 makespan at queue depths 2 and 10,
  * HQ *loses* CPU time on sub-second tasks (the ~1 s server init),
  * HQ SLR ~ 1, SLURM SLR >> 1 for short tasks,
  * UM-Bridge SLURM backend shows no gain over naive SLURM (Appendix A).

The simulator is seeded end-to-end: same seed -> identical schedules.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.backends import BackendSpec, lognormal as _lognormal
from repro_torch.core.metrics import TaskRecord
from repro_torch.core.task import EvalRequest
from repro_torch.sched import make_policy, make_predictor
from repro_torch.sched.policy import WorkerView


@dataclasses.dataclass(frozen=True)
class Workload:
    """One benchmark column of the paper's Table III (seconds)."""
    name: str
    runtimes: Tuple[float, ...]      # per-task application compute times
    n_cpus: int = 1
    slurm_alloc: float = 60.0        # SLURM per-job time limit
    hq_alloc: float = 600.0          # HQ bulk allocation length
    time_request: float = 60.0       # HQ per-job time request (packing hint)
    time_limit: float = 300.0        # HQ per-job time limit (kill bound)

    @property
    def n_tasks(self) -> int:
        return len(self.runtimes)


PRELIM_COMPUTE = 0.05                # readiness-probe compute seconds


def simulate(spec: BackendSpec, workload: Workload, queue_depth: int,
             seed: int = 0, node_cores: int = 128,
             include_preliminary: bool = True) -> List[TaskRecord]:
    """Run one benchmark (all tasks) under one backend; return records."""
    rng = np.random.default_rng(seed)
    records: List[TaskRecord] = []

    per_job_limit = (workload.time_limit if spec.bulk_allocation
                     else workload.slurm_alloc)
    alloc_request = (workload.hq_alloc if spec.bulk_allocation
                     else workload.slurm_alloc)
    wait_median = spec.queue_wait_median(alloc_request, workload.n_cpus)
    env_median = spec.env_reinit_median(workload.slurm_alloc)

    # ---- bulk allocation (HQ): one queue wait up front -----------------
    if spec.bulk_allocation:
        ready = _lognormal(rng, wait_median, spec.queue_wait_sigma)
    else:
        ready = 0.0

    # in-flight window: list of (start, end) of running jobs
    inflight: List[Tuple[float, float]] = []
    t_user = 0.0                      # next submission opportunity

    def submit_one(idx: str, compute: float, is_prelim: bool) -> TaskRecord:
        nonlocal t_user, inflight
        if len(inflight) >= queue_depth:
            # wait for a slot: the earliest-finishing in-flight job
            t_done = min(end for _, end in inflight)
            inflight = [(s, e) for s, e in inflight if e != t_done] + \
                [(s, e) for s, e in inflight if e == t_done][1:]
            t_user = max(t_user, t_done)
        submit = t_user
        if spec.bulk_allocation:
            # persistent workers: only dispatch latency per task, but the
            # allocation itself must be up before anything runs
            start = max(submit + spec.dispatch_latency, ready)
            env = 0.0
            factor = 1.0
            worker = f"hq-worker-{len(inflight)}"
        else:
            # fresh per-job allocation: queue wait + env re-init +
            # co-residency contention (SLURM packs this user's jobs while
            # queue_depth * n_cpus fits one node)
            wait = _lognormal(rng, wait_median, spec.queue_wait_sigma)
            start = submit + spec.dispatch_latency + wait
            env = _lognormal(rng, env_median, spec.env_reinit_sigma)
            packed = (queue_depth * workload.n_cpus) <= node_cores
            cojobs = sum(1 for s, e in inflight if s <= start < e) if packed \
                else 0
            factor = 1.0 + spec.contention_per_cojob * cojobs
            worker = "node-0" if packed else f"node-{len(inflight)}"
        run = compute * factor
        cpu = env + spec.server_init + run
        status = "preliminary" if is_prelim else "ok"
        if cpu > per_job_limit and not is_prelim:
            cpu = per_job_limit
            status = "timeout"
        end = start + cpu
        inflight.append((start, end))
        rec = TaskRecord(task_id=idx, submit_t=submit, start_t=start,
                         end_t=end, cpu_time=cpu,
                         compute_t=(compute if status != "timeout"
                                    else max(per_job_limit - env
                                             - spec.server_init, 0.0)),
                         worker=worker, status=status)
        records.append(rec)
        return rec

    # ---- preliminary readiness jobs (load-balancer design, §V) ---------
    if include_preliminary and spec.preliminary_jobs:
        for p in range(spec.preliminary_jobs):
            submit_one(f"{workload.name}-prelim-{p}", PRELIM_COMPUTE, True)

    for i, r in enumerate(workload.runtimes):
        submit_one(f"{workload.name}-{i}", float(r), False)

    return records


def simulate_policy(spec: BackendSpec, workload: Workload,
                    n_workers: int = 2, policy: Any = "fcfs",
                    predictor: Any = None, seed: int = 0,
                    hints: Any = "workload",
                    parameters: Optional[Sequence[Sequence[float]]] = None,
                    model_names: Optional[Sequence[str]] = None
                    ) -> List[TaskRecord]:
    """Policy-driven discrete-event run: the SAME `SchedulingPolicy` /
    `RuntimePredictor` objects that drive the live `Executor` schedule a
    seeded virtual worker pool, so predicted-vs-actual schedules are
    comparable deterministically (same seed + same policy -> identical
    records).

    Where `simulate` reproduces the paper's queue-depth submission model
    verbatim, this models THIS repo's executor: all tasks are submitted up
    front, `n_workers` workers pull from the policy, and under a bulk
    allocation servers stay warm per worker (persistent-server semantics),
    with the allocation renewed — new queue wait, cold servers — when it
    runs out.  Per-job backends pay a queue wait + env re-init per task,
    exactly as in `simulate`.

    `hints` controls the HQ-style time-request hint on each request:
    "workload" (the static per-workload request — what the paper's users
    provide), "oracle" (the true runtime — perfect hints), None, or a
    per-task sequence.  `parameters` optionally attaches input-parameter
    vectors so a GP predictor can learn the runtime surface; `model_names`
    optionally labels tasks with distinct model servers (multi-model UQ
    campaigns) so per-model predictors and locality-aware policies have
    something to discriminate on.
    """
    rng = np.random.default_rng(seed)
    pol = make_policy(policy, make_predictor(predictor))

    per_job_limit = (workload.time_limit if spec.bulk_allocation
                     else workload.slurm_alloc)
    alloc_request = (workload.hq_alloc if spec.bulk_allocation
                     else workload.slurm_alloc)
    wait_median = spec.queue_wait_median(alloc_request, workload.n_cpus)
    env_median = spec.env_reinit_median(workload.slurm_alloc)

    runtimes = {}
    for i, r in enumerate(workload.runtimes):
        if hints == "oracle":
            hint: Optional[float] = float(r)
        elif hints == "workload":
            hint = workload.time_request
        elif hints is None:
            hint = None
        else:
            hint = float(hints[i])
        req = EvalRequest(
            model_name=(model_names[i] if model_names is not None
                        else workload.name),
            parameters=([list(map(float, parameters[i]))] if parameters
                        is not None else [[float(i)]]),
            time_request=hint, time_limit=workload.time_limit,
            n_cpus=workload.n_cpus, task_id=f"{workload.name}-{i}")
        runtimes[req.task_id] = float(r)
        pol.push(req, 1)

    ready = (_lognormal(rng, wait_median, spec.queue_wait_sigma)
             if spec.bulk_allocation else 0.0)
    workers = [{"free": ready, "warm": set(),
                "alloc_end": ready + workload.hq_alloc}
               for _ in range(n_workers)]
    # completions not yet visible to the predictor: (end_t, req, compute)
    to_observe: List[Tuple[float, int, EvalRequest, float]] = []
    obs_tick = 0
    records: List[TaskRecord] = []

    while len(pol):
        wid = min(range(n_workers), key=lambda j: workers[j]["free"])
        w = workers[wid]
        if spec.bulk_allocation and w["free"] >= w["alloc_end"]:
            # allocation exhausted: renew (one more queue wait, cold start)
            # and RE-SELECT — another worker may now be free earlier
            w["free"] += _lognormal(rng, wait_median, spec.queue_wait_sigma)
            w["alloc_end"] = w["free"] + workload.hq_alloc
            w["warm"].clear()
            continue
        now = w["free"]
        if pol.predictor is not None:          # completions up to `now`
            while to_observe and to_observe[0][0] <= now:
                _, _, done_req, done_compute = heapq.heappop(to_observe)
                pol.predictor.observe(done_req, done_compute)
        budget = (w["alloc_end"] - now) if spec.bulk_allocation else None
        view = WorkerView(wid=wid, warm_models=frozenset(w["warm"]),
                          budget_left=budget)
        item = pol.pop(view)
        if item is None:
            break
        req, _ = item
        compute = runtimes[req.task_id]
        if spec.bulk_allocation:
            start = now + spec.dispatch_latency
            env = 0.0
            init = (0.0 if req.model_name in w["warm"] else spec.server_init)
            w["warm"].add(req.model_name)
        else:
            start = (now + spec.dispatch_latency
                     + _lognormal(rng, wait_median, spec.queue_wait_sigma))
            env = _lognormal(rng, env_median, spec.env_reinit_sigma)
            init = spec.server_init
        cpu = env + init + compute
        status = "ok"
        if cpu > per_job_limit:
            cpu = per_job_limit
            status = "timeout"
            compute = max(per_job_limit - env - init, 0.0)
        end = start + cpu
        w["free"] = end
        if pol.predictor is not None and status == "ok":
            obs_tick += 1
            heapq.heappush(to_observe, (end, obs_tick, req, compute))
        records.append(TaskRecord(
            task_id=req.task_id, submit_t=0.0, start_t=start, end_t=end,
            cpu_time=cpu, compute_t=compute, worker=f"sim-worker-{wid}",
            status=status))
    return records


def eval_records(records: Sequence[TaskRecord]) -> List[TaskRecord]:
    """Drop the preliminary readiness probes (kept for makespan realism,
    excluded from CPU-time statistics like the paper's 'blend into the
    typical runtime range' remark)."""
    return [r for r in records if r.status != "preliminary"]
