"""The port's live scheduler against `repro`: twins of
tests/test_cluster.py, tests/test_obs.py, tests/test_metrics.py and
tests/test_offload.py.

These modules (`core.{executor,metrics}`, `cluster.{allocation,autoalloc,
broker,stepper}`, `obs.{trace,attribution}`, `chaos.speculate`,
`sched.policy`, `sched.offload`) are the reference's, copied with the
imports rewritten.  Each twin runs the reference case through both
packages (`twin`): the same inputs, the reference's asserts on each
side, equal observations.  Cases whose outcome is a property of thread
timing (an autoallocator that grows and drains back, a pool that never
passes its cap, virtual workers that come up) hold the port to the same
property and compare nothing timed.

The GP runs only in the offload cases.  There the reference fits the
surrogate and the port gets its posterior (`export_posterior`), or its
runtime predictor installs the reference's fit (`carry_reference_fit`);
predictions are held at 1e-4.
"""
import functools
import json
import math
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest

import repro.cluster as jcluster
import repro.core as jcore
import repro.obs as jobs
import repro.sched as jsched
import repro_torch.cluster as tcluster
import repro_torch.core as tcore
import repro_torch.obs as tobs
import repro_torch.sched as tsched
from repro.core import metrics as jmetrics
from repro.core import task as jtask
from repro.sched import predictor as jpredictor
from repro.uq import gp as jgp
from repro_torch.core import metrics as tmetrics
from repro_torch.core import task as ttask
from repro_torch.sched import predictor as tpredictor
from repro_torch.uq import gp as tgp
from torch_port_util import (carry_reference_fit,  # noqa: F401
                             export_posterior, np32, on_cpu, plain, twin)

pytestmark = pytest.mark.usefixtures("on_cpu")

J = types.SimpleNamespace(name="repro", cluster=jcluster, core=jcore,
                          obs=jobs, sched=jsched, metrics=jmetrics,
                          task=jtask, predictor=jpredictor, gp=jgp,
                          array=lambda v: jnp.asarray(v, jnp.float32))
T = types.SimpleNamespace(name="repro_torch", cluster=tcluster, core=tcore,
                          obs=tobs, sched=tsched, metrics=tmetrics,
                          task=ttask, predictor=tpredictor, gp=tgp,
                          array=lambda v: tgp.as_f32(v, "cpu"))
PAIR = (J, T)


def _req(p, cost=None, model="m", task_id="", deadline=None):
    return p.core.EvalRequest(model, [[0.0]], time_request=cost,
                              task_id=task_id, deadline=deadline)


# ==========================================================================
# tests/test_cluster.py
# ==========================================================================
def _lifecycle(p):
    a = p.cluster.Allocation(0, n_workers=2, walltime_s=100.0)
    assert a.state == "pending" and a.budget_left(0.0) == 100.0
    a.submit(10.0, queue_wait=5.0)
    assert a.state == "queued" and a.grant_t == 15.0 and a.expiry_t == 115.0
    obs = [a.tick(12.0), a.tick(15.0), a.ready_t, a.budget_left(65.0)]
    assert obs[:3] == ["queued", "running", 15.0]
    assert obs[3] == pytest.approx(50.0)
    a.drain(70.0)
    assert a.state == "draining" and not a.open
    obs += [a.tick(115.0), a.end_t, a.node_seconds()]
    assert obs[4:6] == ["expired", 115.0]
    assert obs[6] == pytest.approx(2 * 100.0)
    return obs, a.record()


def test_allocation_lifecycle_states():
    twin(PAIR, _lifecycle)


def _drain_queued(p):
    a = p.cluster.Allocation(1, 4, 300.0).submit(0.0, queue_wait=60.0)
    a.drain(10.0)
    assert a.state == "expired" and a.node_seconds() == 0.0
    return a.record()


def test_allocation_drain_while_queued_cancels():
    twin(PAIR, _drain_queued)


def _terminate_early(p):
    a = p.cluster.Allocation(2, 2, 1000.0).submit(0.0, 0.0)
    a.tick(0.0)
    a.note_busy(30.0)
    a.terminate(50.0)
    assert a.node_seconds() == pytest.approx(100.0)
    rec = a.record()
    assert rec.busy_t == pytest.approx(30.0) and rec.state == "expired"
    return rec


def test_allocation_terminate_early_stops_billing():
    twin(PAIR, _terminate_early)


def _unbounded(p):
    a = p.cluster.Allocation(3, 1, None).submit(0.0, 0.0)
    a.tick(0.0)
    assert a.budget_left(1e6) is None
    return a.record()


def test_allocation_unbounded_budget_is_none():
    twin(PAIR, _unbounded)


def _running_alloc(p, broker, n_workers=1, walltime=1000.0, t=0.0):
    a = p.cluster.Allocation(broker.next_alloc_id(), n_workers, walltime)
    a.submit(t, 0.0)
    a.tick(t)
    broker.add_allocation(a)
    return a


def _broker_rejects(p):
    assert type(p.sched.make_policy("broker")) is p.cluster.Broker
    refused = []
    for bad in (p.sched.make_policy("sjf"), "broker", p.cluster.Broker):
        with pytest.raises(TypeError) as ei:
            b = p.cluster.Broker(policy=bad)
            _running_alloc(p, b)
        refused.append(str(ei.value))
    return refused


def test_broker_registered_and_rejects_shared_instance():
    twin(PAIR, _broker_rejects)


def _backlog_composition(p):
    b = p.cluster.Broker()
    a = _running_alloc(p, b)
    b.push(_req(p, cost=1.0, task_id="cheap"), 1)
    obs = [b.backlog_cost()]
    assert b.pop(p.sched.WorkerView(wid=0, alloc_id=a.alloc_id))[0] \
        .task_id == "cheap"
    b.push(_req(p, cost=500.0, task_id="dear"), 1)
    obs.append(b.backlog_cost())
    a2 = _running_alloc(p, b)
    b.drain_allocation(a.alloc_id, now=1.0)
    assert b.queued_on(a2.alloc_id) == 1
    obs.append(b.backlog_cost())
    assert b.pop(p.sched.WorkerView(wid=1, alloc_id=a2.alloc_id)) is not None
    obs.append(b.backlog_cost())
    assert obs == pytest.approx([1.0, 500.0, 500.0, 0.0])
    return obs


def test_broker_backlog_cost_tracks_composition_changes():
    twin(PAIR, _backlog_composition)


def _toy_factory(p):
    def make():
        time.sleep(0.01)
        return p.task.LambdaModel("toy",
                                  lambda q, c: [[float(q[0][0]) * 2]], 1, 1)
    return make


def _slow_factory(p):
    def make():
        return p.task.LambdaModel(
            "toy", lambda q, c: (time.sleep(0.03),
                                 [[float(q[0][0]) * 2]])[1], 1, 1)
    return make


def _broker_policy_autoalloc(p):
    cfg = p.cluster.AutoAllocConfig(
        workers_per_alloc=1, walltime_s=None, backlog_high_s=3.0,
        max_allocations=2, min_allocations=1, idle_drain_s=30.0,
        hysteresis_s=0.05)
    with p.core.Executor({"toy": _toy_factory(p)}, n_workers=1,
                         policy="broker", autoalloc=cfg) as ex:
        res = ex.run_all([p.core.EvalRequest("toy", [[i]])
                          for i in range(6)], 30)
        values = [r.value[0][0] for r in res]
        assert values == [2.0 * i for i in range(6)]
        return values


def test_executor_broker_policy_with_autoalloc_serves():
    twin(PAIR, _broker_policy_autoalloc)


def _elastic_cfg(p, **kw):
    base = dict(workers_per_alloc=2, walltime_s=300.0, backlog_high_s=30.0,
                backlog_low_s=5.0, max_pending=2, max_allocations=4,
                min_allocations=0, idle_drain_s=20.0, hysteresis_s=5.0)
    base.update(kw)
    return p.cluster.AutoAllocConfig(**base)


def _honors_allocator(p):
    spec = p.core.backends.get("hq")
    allocator = p.cluster.AutoAllocator(_elastic_cfg(p, workers_per_alloc=3),
                                        spec=spec, seed=2)
    trace = p.cluster.bursty_trace(n_bursts=1, burst_size=6, runtime_s=5.0,
                                   seed=2)
    res = p.cluster.simulate_cluster(spec, trace, autoalloc=allocator,
                                     seed=2)
    assert all(r.status == "ok" for r in res.records)
    assert all(a.n_workers == 3 for a in res.allocations)
    with pytest.raises(TypeError):
        p.cluster.simulate_cluster(spec, trace, autoalloc=42, seed=2)
    return res.records, res.allocations, res.decisions


def test_sim_cluster_honors_allocator_via_autoalloc_kwarg():
    twin(PAIR, _honors_allocator)


def _unrouted_flush(p):
    b = p.cluster.Broker()
    b.push(_req(p, task_id="t0"), 1)
    assert len(b) == 1 and b.backlog_cost(default=2.0) == 2.0
    a = _running_alloc(p, b)
    assert b.queued_on(a.alloc_id) == 1
    item = b.pop(p.sched.WorkerView(wid=0, alloc_id=a.alloc_id))
    assert item[0].task_id == "t0"
    return item[0].task_id, item[1]


def test_broker_unrouted_buffer_flushes_on_capacity():
    twin(PAIR, _unrouted_flush)


def _affinity(p):
    b = p.cluster.Broker()
    a0, a1 = _running_alloc(p, b), _running_alloc(p, b)
    b.push(_req(p, cost=10.0, model="gs2", task_id="g0"), 1)
    first = a0.alloc_id if b.queued_on(a0.alloc_id) else a1.alloc_id
    b.push(_req(p, cost=10.0, model="gs2", task_id="g1"), 1)
    assert b.queued_on(first) == 2
    b.push(_req(p, cost=1.0, model="eig", task_id="e0"), 1)
    other = a1.alloc_id if first == a0.alloc_id else a0.alloc_id
    assert b.queued_on(other) == 1
    return first, other


def test_broker_affinity_and_least_loaded_routing():
    twin(PAIR, _affinity)


def _drain_migrates(p):
    b = p.cluster.Broker()
    a0, a1 = _running_alloc(p, b), _running_alloc(p, b)
    for i in range(3):
        b.push(_req(p, model="m", task_id=f"t{i}"), 1)
    src = a0 if b.queued_on(a0.alloc_id) else a1
    dst = a1 if src is a0 else a0
    assert b.queued_on(src.alloc_id) == 3
    b.drain_allocation(src.alloc_id, now=10.0)
    assert src.state == "draining"
    assert b.queued_on(src.alloc_id) == 0
    assert b.queued_on(dst.alloc_id) == 3
    assert len(b) == 3
    return src.alloc_id, dst.alloc_id


def test_broker_drain_migrates_queue():
    twin(PAIR, _drain_migrates)


def _remove_last(p):
    b = p.cluster.Broker()
    a0 = _running_alloc(p, b)
    b.push(_req(p, task_id="t0"), 1)
    b.remove_allocation(a0.alloc_id, now=5.0)
    assert b.allocation(a0.alloc_id) is None
    assert len(b) == 1
    a1 = _running_alloc(p, b)
    assert b.queued_on(a1.alloc_id) == 1
    return a1.alloc_id


def test_broker_remove_last_allocation_parks_tasks_unrouted():
    twin(PAIR, _remove_last)


def _stealing(p):
    b = p.cluster.Broker()
    a0, a1 = _running_alloc(p, b), _running_alloc(p, b)
    b.push(_req(p, cost=5.0, model="gs2", task_id="g0"), 1)
    loaded = a0 if b.queued_on(a0.alloc_id) else a1
    idle = a1 if loaded is a0 else a0
    item = b.pop(p.sched.WorkerView(wid=9, alloc_id=idle.alloc_id))
    assert item[0].task_id == "g0"
    b.push(_req(p, cost=5.0, model="gs2", task_id="g1"), 1)
    assert b.queued_on(idle.alloc_id) == 1
    b.drain_allocation(idle.alloc_id, now=1.0)
    assert b.pop(p.sched.WorkerView(wid=9, alloc_id=idle.alloc_id)) is None
    return loaded.alloc_id, idle.alloc_id


def test_broker_cluster_level_stealing_moves_affinity():
    twin(PAIR, _stealing)


def _cfg(p, **kw):
    base = dict(workers_per_alloc=1, walltime_s=100.0, backlog_high_s=30.0,
                backlog_low_s=5.0, max_pending=2, max_allocations=4,
                min_allocations=0, idle_drain_s=10.0, hysteresis_s=5.0)
    base.update(kw)
    return p.cluster.AutoAllocConfig(**base)


def _bootstrap(p):
    b = p.cluster.Broker()
    aa = p.cluster.AutoAllocator(_cfg(p))
    b.push(_req(p, cost=1.0), 1)
    actions = [a for a, _ in aa.step(0.0, b, {})]
    assert actions == ["submit"]
    return actions, aa.decisions


def test_autoalloc_bootstraps_cold_cluster():
    twin(PAIR, _bootstrap)


def _grows_on_cost(p):
    b = p.cluster.Broker()
    aa = p.cluster.AutoAllocator(_cfg(p))
    _running_alloc(p, b)
    b.push(_req(p, cost=500.0), 1)
    first = [a for a, _ in aa.step(0.0, b, {0: 1})]
    assert first == ["submit"]
    b2 = p.cluster.Broker()
    aa2 = p.cluster.AutoAllocator(_cfg(p))
    _running_alloc(p, b2)
    for i in range(20):
        b2.push(_req(p, cost=1.0, task_id=f"s{i}"), 1)
    assert aa2.step(0.0, b2, {0: 1}) == []
    return first, aa.decisions


def test_autoalloc_grows_on_backlog_cost_not_count():
    twin(PAIR, _grows_on_cost)


def _max_pending(p):
    b = p.cluster.Broker()
    aa = p.cluster.AutoAllocator(_cfg(p, max_pending=1, hysteresis_s=0.0))
    queued = p.cluster.Allocation(b.next_alloc_id(), 1, 100.0) \
        .submit(0.0, 50.0)
    b.add_allocation(queued)
    b.push(_req(p, cost=500.0), 1)
    assert aa.step(1.0, b, {}) == []
    queued.tick(60.0)
    second = [a for a, _ in aa.step(60.0, b, {queued.alloc_id: 1})]
    assert second == ["submit"]
    return aa.decisions


def test_autoalloc_max_pending_cap():
    twin(PAIR, _max_pending)


def _drains_idle(p):
    b = p.cluster.Broker()
    aa = p.cluster.AutoAllocator(_cfg(p, idle_drain_s=10.0, hysteresis_s=0.0))
    a0 = _running_alloc(p, b)
    states = []
    for t in (0.0, 9.0, 10.0):
        aa.step(t, b, {a0.alloc_id: 0})
        states.append(a0.state)
    assert states == ["running", "running", "draining"]
    assert aa.decisions[-1]["action"] == "drain"
    return states, aa.decisions


def test_autoalloc_drains_idle_allocation():
    twin(PAIR, _drains_idle)


def _busy_resets(p):
    b = p.cluster.Broker()
    aa = p.cluster.AutoAllocator(_cfg(p, idle_drain_s=10.0, hysteresis_s=0.0))
    a0 = _running_alloc(p, b)
    states = []
    for t, busy in ((0.0, 0), (8.0, 1), (12.0, 0), (22.0, 0)):
        aa.step(t, b, {a0.alloc_id: busy})
        states.append(a0.state)
    assert states[2] == "running" and states[3] == "draining"
    return states, aa.decisions


def test_autoalloc_busy_resets_idle_clock():
    twin(PAIR, _busy_resets)


def _min_allocations(p):
    b = p.cluster.Broker()
    aa = p.cluster.AutoAllocator(_cfg(p, min_allocations=1, hysteresis_s=0.0))
    a0 = _running_alloc(p, b)
    for t in (0.0, 20.0, 40.0):
        aa.step(t, b, {a0.alloc_id: 0})
    assert a0.state == "running"
    return a0.state, aa.decisions


def test_autoalloc_respects_min_allocations():
    twin(PAIR, _min_allocations)


def _hysteresis(p):
    b = p.cluster.Broker()
    aa = p.cluster.AutoAllocator(_cfg(p, hysteresis_s=10.0,
                                      max_allocations=64, max_pending=64,
                                      idle_drain_s=2.0))
    _running_alloc(p, b)
    big = 0
    for step in range(100):
        t = float(step)
        if step % 2 == 0:
            b.push(_req(p, cost=500.0, task_id=f"osc-{big}"), 1)
            big += 1
        else:
            while b.pop(p.sched.WorkerView(wid=0, alloc_id=0)) is not None:
                pass
        aa.step(t, b, {a.alloc_id: 0 for a in b.allocations()})
    assert len(aa.decisions) <= 100 / 10.0 + 1, len(aa.decisions)
    return aa.decisions


def test_autoalloc_hysteresis_no_flapping():
    twin(PAIR, _hysteresis)


def _static_deterministic(p):
    spec = p.core.backends.get("hq")
    trace = p.cluster.bimodal_trace(n=30, seed=4)
    a = p.cluster.simulate_cluster(spec, trace, n_workers=3, seed=9)
    b = p.cluster.simulate_cluster(spec, trace, n_workers=3, seed=9)
    assert plain(a.records) == plain(b.records)
    assert plain(a.allocations) == plain(b.allocations)
    assert len(a.records) == 30
    assert all(r.status == "ok" for r in a.records)
    return a.records, a.allocations


def test_sim_cluster_static_deterministic():
    twin(PAIR, _static_deterministic)


def _renewal(p):
    spec = p.core.backends.get("hq")
    trace = p.cluster.bursty_trace(n_bursts=3, burst_size=10, gap_s=400.0,
                                   runtime_s=15.0, seed=2)
    kw = dict(autoalloc=_elastic_cfg(p), seed=7)
    a = p.cluster.simulate_cluster(spec, trace, **kw)
    b = p.cluster.simulate_cluster(spec, trace, **kw)
    assert plain(a.records) == plain(b.records)
    assert plain(a.allocations) == plain(b.allocations)
    assert a.decisions == b.decisions
    assert len(a.allocations) >= 3
    assert {d["action"] for d in a.decisions} == {"submit", "drain"}
    ids = [r.task_id for r in a.records]
    assert len(ids) == len(set(ids)) == len(trace)
    return a.records, a.allocations, a.decisions


def test_sim_cluster_renewal_and_drain_deterministic():
    twin(PAIR, _renewal)


def _walltime_requeues(p):
    trace = p.cluster.bursty_trace(n_bursts=1, burst_size=4,
                                   burst_span_s=1.0, runtime_s=40.0,
                                   jitter=0.0, seed=0)
    cfg = _elastic_cfg(p, workers_per_alloc=1, walltime_s=60.0,
                       idle_drain_s=50.0)
    res = p.cluster.simulate_cluster(p.core.backends.get("hq"), trace,
                                     autoalloc=cfg, seed=3, max_attempts=6)
    assert all(r.status == "ok" for r in res.records)
    assert len(res.records) == 4
    assert max(r.attempts for r in res.records) > 1
    assert len(res.allocations) > 1
    return res.records, res.allocations


def test_sim_cluster_walltime_kill_requeues():
    twin(PAIR, _walltime_requeues)


def _lost_records(p):
    trace = p.cluster.bursty_trace(n_bursts=1, burst_size=6,
                                   burst_span_s=1.0, runtime_s=50.0,
                                   jitter=0.0, seed=0)
    res = p.cluster.simulate_cluster(p.core.backends.get("hq"), trace,
                                     n_workers=1, walltime_s=60.0, seed=0)
    assert len(res.records) == 6
    by_status = {}
    for r in res.records:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    assert by_status.get("lost", 0) >= 1
    s = res.summary()
    assert s["n_tasks"] == 6 and s["n_ok"] < 6
    return res.records, s


def test_sim_cluster_unservable_tasks_get_lost_records():
    twin(PAIR, _lost_records)


def _resize_bills(p):
    a = p.cluster.Allocation(0, 1, None).submit(0.0, 0.0)
    a.tick(0.0)
    a.resize(4, 100.0)
    a.terminate(110.0)
    assert a.node_seconds() == pytest.approx(1 * 100.0 + 4 * 10.0)
    assert a.record().node_s == pytest.approx(140.0)
    assert p.metrics.node_seconds([a.record()]) == pytest.approx(140.0)
    return a.record()


def test_allocation_resize_bills_time_weighted():
    twin(PAIR, _resize_bills)


def test_executor_max_workers_caps_autoalloc():
    """Thread-timing property, on the port: the pool never passes its
    cap of 3 while the allocator wants groups of 8."""
    cfg = tcluster.AutoAllocConfig(
        workers_per_alloc=8, walltime_s=None, backlog_high_s=1.0,
        backlog_low_s=0.5, max_pending=8, max_allocations=8,
        min_allocations=1, idle_drain_s=30.0, hysteresis_s=0.05)
    with tcore.Executor({"toy": _slow_factory(T)}, n_workers=1,
                        autoalloc=cfg, max_workers=3) as ex:
        ids = [ex.submit(tcore.EvalRequest("toy", [[i]])) for i in range(40)]
        peak = 0
        res = []
        for t in ids:
            res.append(ex.result(t, 60))
            peak = max(peak, ex.n_workers())
        assert all(r.status == "ok" for r in res)
        assert [r.value[0][0] for r in res] == [2.0 * i for i in range(40)]
        assert peak <= 3, peak


def _elasticity_claim(p):
    spec = p.core.backends.get("hq")
    statics = {}
    for n in (2, 4, 8):
        trace = p.cluster.bursty_trace(n_bursts=3, burst_size=12,
                                       gap_s=500.0, runtime_s=15.0, seed=5)
        span = max(t.t for t in trace)
        res = p.cluster.simulate_cluster(spec, trace, n_workers=n,
                                         walltime_s=span + 1200.0, seed=5)
        assert all(r.status == "ok" for r in res.records)
        statics[n] = res.summary()
    trace = p.cluster.bursty_trace(n_bursts=3, burst_size=12, gap_s=500.0,
                                   runtime_s=15.0, seed=5)
    auto = p.cluster.simulate_cluster(spec, trace, autoalloc=_elastic_cfg(p),
                                      seed=5).summary()
    best = min(statics.values(), key=lambda s: s["makespan"])
    assert auto["node_seconds"] < best["node_seconds"]
    assert auto["makespan"] <= 1.10 * best["makespan"]
    return statics, auto


def test_sim_cluster_elasticity_claim():
    twin(PAIR, _elasticity_claim)


def _same_objects(p):
    spec = p.core.backends.get("hq")
    broker = p.cluster.Broker(policy="pack")
    allocator = p.cluster.AutoAllocator(_elastic_cfg(p), spec=spec, seed=1)
    trace = p.cluster.bursty_trace(n_bursts=2, burst_size=8, gap_s=300.0,
                                   runtime_s=10.0, seed=1)
    res = p.cluster.simulate_cluster(spec, trace, broker=broker,
                                     allocator=allocator, seed=1)
    assert all(r.status == "ok" for r in res.records)
    assert res.decisions is not None and len(allocator.decisions) > 0
    assert len(broker) == 0
    allocator2 = p.cluster.AutoAllocator(_elastic_cfg(
        p, min_allocations=1, hysteresis_s=0.05, backlog_high_s=3.0,
        idle_drain_s=30.0))
    with p.core.Executor({"toy": _toy_factory(p)}, n_workers=1,
                         policy="pack", autoalloc=allocator2) as ex:
        assert ex.autoalloc is allocator2
        assert isinstance(ex.policy, p.cluster.Broker)
        live = ex.run_all([p.core.EvalRequest("toy", [[i]])
                           for i in range(8)])
        assert all(r.status == "ok" for r in live)
    return res.records, allocator.decisions, [r.value for r in live]


def test_sim_cluster_same_objects_as_executor():
    twin(PAIR, _same_objects)


def test_executor_autoalloc_grows_and_drains():
    """Thread-timing property, on the port: backlog cost grows the pool
    and the idle drain shrinks it back to one worker."""
    cfg = tcluster.AutoAllocConfig(
        workers_per_alloc=2, walltime_s=None, backlog_high_s=3.0,
        backlog_low_s=1.0, max_pending=4, max_allocations=4,
        min_allocations=1, idle_drain_s=0.2, hysteresis_s=0.05)
    with tcore.Executor({"toy": _slow_factory(T)}, n_workers=1,
                        autoalloc=cfg) as ex:
        ids = [ex.submit(tcore.EvalRequest("toy", [[i]])) for i in range(40)]
        res = [ex.result(t, 60) for t in ids]
        assert [r.value[0][0] for r in res] == [2.0 * i for i in range(40)]
        assert ex.metrics()["allocations_total"] > 1
        deadline = time.monotonic() + 30.0
        while ex.n_workers() > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ex.n_workers() == 1
        assert any(d["action"] == "drain" for d in ex.autoalloc.decisions)
    recs = ex.allocation_records()
    assert tmetrics.node_seconds(recs) > 0
    assert 0.0 < tmetrics.allocation_utilization(recs) <= 1.0


def test_executor_autoscale_backlog_alias_routes_through_autoalloc():
    """Thread-timing property, on the port."""
    with tcore.Executor({"toy": _slow_factory(T)}, n_workers=1,
                        autoscale_backlog=3, max_workers=4) as ex:
        assert ex.autoalloc is not None
        assert isinstance(ex.policy, tcluster.Broker)
        ids = [ex.submit(tcore.EvalRequest("toy", [[i]])) for i in range(30)]
        res = [ex.result(t, 30) for t in ids]
        assert all(r.status == "ok" for r in res)
        assert ex.n_workers() > 1
        assert ex.n_workers() <= 4


def _absolute_backlog(p):
    b = p.cluster.Broker()
    aa = p.cluster.AutoAllocator(_cfg(p, backlog_high_s=3.0,
                                      per_worker=False))
    _running_alloc(p, b, n_workers=4)
    for i in range(10):
        b.push(_req(p, cost=1.0, task_id=f"a{i}"), 1)
    actions = [a for a, _ in aa.step(0.0, b, {0: 4})]
    assert actions == ["submit"]
    return aa.decisions


def test_autoalloc_absolute_backlog_mode():
    twin(PAIR, _absolute_backlog)


def test_executor_autoscale_alias_grows_wide_pools():
    """Thread-timing property, on the port."""
    with tcore.Executor({"toy": _slow_factory(T)}, n_workers=4,
                        autoscale_backlog=3, max_workers=6) as ex:
        ids = [ex.submit(tcore.EvalRequest("toy", [[i]])) for i in range(60)]
        res = [ex.result(t, 60) for t in ids]
        assert all(r.status == "ok" for r in res)
        assert ex.metrics()["allocations_total"] > 1
        assert ex.n_workers() <= 6


def test_executor_scale_to_after_full_drain_still_serves():
    """Thread-timing property, on the port: every group drains away,
    then a manual scale-up serves on a fresh open group."""
    cfg = tcluster.AutoAllocConfig(
        workers_per_alloc=1, walltime_s=None, backlog_high_s=3.0,
        backlog_low_s=1.0, max_allocations=2, min_allocations=0,
        idle_drain_s=0.1, hysteresis_s=0.05)
    with tcore.Executor({"toy": _toy_factory(T)}, n_workers=1,
                        autoalloc=cfg) as ex:
        res = ex.run_all([tcore.EvalRequest("toy", [[i]]) for i in range(4)],
                         30)
        assert all(r.status == "ok" for r in res)
        deadline = time.monotonic() + 30.0
        while ex.n_workers() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ex.n_workers() == 0
        ex.scale_to(2)
        assert ex.n_workers() == 2
        res = ex.run_all([tcore.EvalRequest("toy", [[i]]) for i in range(6)],
                         30)
        assert [r.value[0][0] for r in res] == [2.0 * i for i in range(6)]


def _walltime_kill_attempts(p):
    def sleepy():
        return p.task.LambdaModel(
            "s", lambda q, c: (time.sleep(3.0), [[1.0]])[1], 1, 1)
    with p.core.Executor({"s": sleepy}, n_workers=1, policy="broker",
                         allocation_s=0.3, max_attempts=1) as ex:
        tid = ex.submit(p.core.EvalRequest("s", [[0.0]]))
        res = ex.result(tid, timeout=2.0)
        assert res.status == "failed"
        assert "allocation expired" in res.error
        assert res.attempts == 1
        return res.status, res.attempts, res.error


def test_executor_walltime_kill_counts_attempts_like_sim():
    twin(PAIR, _walltime_kill_attempts)


def test_executor_at_cap_does_not_churn_allocations():
    """Thread-timing property, on the port: at the worker cap the
    allocator submits nothing."""
    cfg = tcluster.AutoAllocConfig(
        workers_per_alloc=2, walltime_s=None, backlog_high_s=1.0,
        backlog_low_s=0.5, max_pending=8, max_allocations=8,
        min_allocations=1, idle_drain_s=30.0, hysteresis_s=0.05)
    with tcore.Executor({"toy": _slow_factory(T)}, n_workers=1,
                        autoalloc=cfg, max_workers=1) as ex:
        assert ex.autoalloc.worker_cap == 1
        ids = [ex.submit(tcore.EvalRequest("toy", [[i]])) for i in range(20)]
        res = [ex.result(t, 30) for t in ids]
        assert all(r.status == "ok" for r in res)
        assert ex.metrics()["allocations_total"] == 1
        assert not any(d["action"] == "submit"
                       for d in ex.autoalloc.decisions)


def _request_max_attempts(p):
    with p.core.Executor({"toy": _toy_factory(p)}, n_workers=2,
                         max_attempts=5) as ex:
        res = ex.run_all([p.core.EvalRequest(
            "toy", [[1]], max_attempts=2,
            config={"fail_attempts": 99})], 30)[0]
        assert res.status == "failed"
        assert res.attempts == 2
        return res.status, res.attempts


def test_executor_respects_request_max_attempts():
    twin(PAIR, _request_max_attempts)


def _cluster_snapshot_restore(p):
    with p.core.Executor({"toy": _toy_factory(p)}, n_workers=1,
                         policy="broker") as ex:
        ids = [ex.submit(p.core.EvalRequest("toy", [[i]], task_id=f"r{i}"))
               for i in range(8)]
        ex.result(ids[0], 10)
        snap = ex.snapshot()
    ex2 = p.core.Executor.restore(snap, {"toy": _toy_factory(p)},
                                  n_workers=2, policy="broker")
    try:
        res = [ex2.result(t, 30) for t in ids]
        assert all(r.status == "ok" for r in res)
        return [(r.task_id, r.status, r.value) for r in res]
    finally:
        ex2.shutdown()


def test_executor_cluster_snapshot_restore():
    twin(PAIR, _cluster_snapshot_restore)


def _snapshot_fields(p):
    with p.core.Executor({"toy": _toy_factory(p)}, n_workers=1) as ex:
        blocked = p.core.EvalRequest(
            "toy", [[7.0]], config={"a": 1}, time_request=12.5,
            time_limit=99.0, n_cpus=4, max_attempts=7, deadline=123.0,
            task_id="rich", depends_on=("never-finishes",))
        ex.submit(blocked)
        snap = ex.snapshot()
    payload = next(q for q in snap["pending"] if q["task_id"] == "rich")
    want = dict(n_cpus=4, max_attempts=7, deadline=123.0, time_request=12.5,
                time_limit=99.0, depends_on=["never-finishes"],
                config={"a": 1})
    assert {k: payload[k] for k in want} == want
    ex2 = p.core.Executor.restore(snap, {"toy": _toy_factory(p)},
                                  n_workers=1)
    try:
        with ex2._lock:
            restored = ex2._requests["rich"]
        for field in ("n_cpus", "max_attempts", "deadline", "time_request",
                      "time_limit", "config"):
            assert getattr(restored, field) == getattr(blocked, field), field
        assert list(restored.depends_on) == list(blocked.depends_on)
        assert ex2.backlog() == 0
    finally:
        ex2.shutdown()
    return payload


def test_snapshot_roundtrip_preserves_all_request_fields():
    payload = twin(PAIR, _snapshot_fields)
    # the payload the port wrote builds the reference's request too
    assert list(jcore.EvalRequest(**payload).depends_on) == \
        ["never-finishes"]


def test_snapshot_holds_a_task_a_worker_has_taken():
    """A task a worker has popped and not yet started is still in the
    snapshot (as running), so a journal written at that instant keeps
    it.  The port's `_queue_get(worker=...)` pops and marks it running
    in one critical section.  The reference pops in `_queue_get` and
    marks in `Worker.run`, each under its own acquisition of the lock:
    a snapshot between the two finds the task nowhere — pinned here,
    as a fault of the reference (a service recovered from such a
    journal waits for the task forever; seen on an H100 in
    chip_smoke.py's `service` phase)."""
    def taken(p, worker):
        ex = p.core.Executor({"toy": _toy_factory(p)}, n_workers=0)
        try:
            ex.submit(p.core.EvalRequest("toy", [[1.0]], task_id="taken"))
            w = worker(ex)
            req, _ = ex._queue_get(0.01, worker=w)
            snap = ex.snapshot()
            return req.task_id, [q["task_id"] for q in snap["pending"]]
        finally:
            ex.shutdown()

    from repro.core.executor import Worker as JWorker
    from repro_torch.core.executor import Worker as TWorker
    assert taken(T, lambda ex: TWorker(ex, 0)) == ("taken", ["taken"])
    # the reference's worker takes the same pop; its snapshot loses it
    assert taken(J, lambda ex: JWorker(ex, 0)) == ("taken", [])


def test_snapshot_holds_a_retry_in_its_backoff():
    """Cluster mode, a RetryPolicy with a backoff: a task that fails once
    is handed to the stepper until its release time, neither queued nor
    running.  The port's snapshot lists it as pending, so a journal
    written during the backoff keeps it.  The reference's reads only the
    policy, the waiting list and the running table: the task is in no
    snapshot, and a broker recovered from one never runs it.  The clock
    stands still and no monitor steps, so the release never comes."""
    def backoff(p):
        ex = p.core.Executor({"toy": _toy_factory(p)}, n_workers=0,
                             cluster=p.cluster.Broker(), clock=lambda: 0.0,
                             monitor_interval=None)
        try:
            req = p.core.EvalRequest(
                "toy", [[1.0]], task_id="backoff",
                retry=p.task.RetryPolicy(base_s=5.0))
            ex.submit(req)
            popped, attempt = ex._queue_get(0.01)
            ex._fail(popped, attempt, "boom", None)
            deferred = [(d[0], d[2].task_id, d[3])
                        for d in ex._stepper._deferred]
            snap = ex.snapshot()
            return deferred, [q["task_id"] for q in snap["pending"]]
        finally:
            ex.shutdown()

    assert backoff(T) == ([(5.0, "backoff", 2)], ["backoff"])
    # the reference defers the same retry; its snapshot loses it
    assert backoff(J) == ([(5.0, "backoff", 2)], [])


def test_snapshots_never_lose_a_task_under_load():
    """Stress, on the port: 8 worker threads drain 600 one-millisecond
    tasks under a 1 µs switch interval while the test thread snapshots
    the executor again and again; every snapshot holds every submitted
    task, as completed or pending (queued or running).  (The same loop
    on the reference loses tasks in some rounds, not all: the
    deterministic pin is the test above.)"""
    def model():
        return ttask.LambdaModel(
            "toy", lambda q, c: (time.sleep(0.001), [[q[0][0]]])[1], 1, 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            with tcore.Executor({"toy": model}, n_workers=8) as ex:
                ids = {ex.submit(tcore.EvalRequest("toy", [[float(i)]],
                                                   task_id=f"s{i}"))
                       for i in range(600)}
                deadline = time.monotonic() + 60.0
                snaps = 0
                while True:
                    snap = ex.snapshot()
                    held = set(snap["completed"]) | \
                        {q["task_id"] for q in snap["pending"]}
                    assert ids <= held, sorted(ids - held)[:5]
                    snaps += 1
                    if len(snap["completed"]) == len(ids):
                        break
                    assert time.monotonic() < deadline
                assert snaps > 1
    finally:
        sys.setswitchinterval(old)


def _waiting_deps(p):
    with p.core.Executor({"toy": _toy_factory(p)}, n_workers=1) as ex:
        a = p.core.EvalRequest("toy", [[1.0]], task_id="dep-a")
        b = p.core.EvalRequest("toy", [[2.0]], task_id="dep-b",
                               depends_on=("dep-a",))
        ex.submit(b)
        snap = ex.snapshot()
    ex2 = p.core.Executor.restore(snap, {"toy": _toy_factory(p)},
                                  n_workers=1)
    try:
        ex2.submit(a)
        res = ex2.result("dep-b", 30)
        assert res.status == "ok" and res.value[0][0] == 4.0
        return res.status, res.value
    finally:
        ex2.shutdown()


def test_snapshot_roundtrip_waiting_deps_release():
    twin(PAIR, _waiting_deps)


def _edf_order(p):
    pol = p.sched.make_policy("edf")
    assert type(pol) is p.sched.EDFPolicy
    for tid, d in (("late", 300.0), ("none1", None), ("soon", 10.0),
                   ("none2", None), ("mid", 100.0)):
        pol.push(_req(p, task_id=tid, deadline=d), 1)
    order = [pol.pop()[0].task_id for _ in range(5)]
    assert order == ["soon", "mid", "late", "none1", "none2"]
    assert pol.pop() is None
    return order


def test_edf_orders_by_deadline_none_last():
    twin(PAIR, _edf_order)


def _edf_pending(p):
    pol = p.sched.EDFPolicy()
    for i, d in enumerate((50.0, None, 5.0)):
        pol.push(_req(p, task_id=f"t{i}", deadline=d), 1)
    assert len(pol) == 3
    ids = [r.task_id for r, _ in pol.pending()]
    assert ids == ["t2", "t0", "t1"]
    return ids


def test_edf_pending_snapshot_and_len():
    twin(PAIR, _edf_pending)


def _edf_live(p):
    with p.core.Executor({"toy": _toy_factory(p)}, n_workers=2,
                         policy="edf") as ex:
        now = time.monotonic()
        reqs = [p.core.EvalRequest("toy", [[i]], deadline=now + 60.0 - i)
                for i in range(10)]
        res = ex.run_all(reqs, timeout=30)
        assert all(r.status == "ok" for r in res)
        return [(r.status, r.value) for r in res]


def test_edf_in_live_executor():
    twin(PAIR, _edf_live)


def _edf_sub_policy(p):
    res = p.cluster.simulate_cluster(p.core.backends.get("hq"),
                                     p.cluster.bimodal_trace(n=20, seed=6),
                                     policy="edf", n_workers=2, seed=6)
    assert all(r.status == "ok" for r in res.records)
    return res.records


def test_edf_as_broker_sub_policy():
    twin(PAIR, _edf_sub_policy)


# ==========================================================================
# tests/test_obs.py
# ==========================================================================
def _ringbuffer(p):
    rb = p.obs.RingBuffer(capacity=4)
    for i in range(10):
        rb.append(i)
    obs = [len(rb), list(rb), rb.n_seen, rb.n_dropped, rb[0], rb[-1]]
    assert obs == [4, [6, 7, 8, 9], 10, 6, 6, 9]
    rb.clear()
    assert len(rb) == 0 and rb.n_dropped == 0
    return obs


def test_ringbuffer_bounds_and_drop_accounting():
    twin(PAIR, _ringbuffer)


def _attempt_spans(p):
    tr = p.obs.Tracer()
    tr.task_queued("t0", 1, ts=0.0)
    tr.task_attempt("t0", alloc_id=2, wid=5, mark_t=3.0, start_t=3.5,
                    init_t=2.0, end_t=10.0, attempt=1, status="ok")
    by_name = {}
    for ev in tr.events():
        by_name.setdefault(ev[2], []).append(ev)
    q = by_name["task.queued"]
    assert [e[1] for e in q] == ["i", "X"]
    assert q[1][0] == 0.0 and q[1][5] == 3.0
    d = by_name["task.dispatch"][0]
    assert d[0] == 3.0 and d[5] == pytest.approx(0.5)
    init = by_name["task.init"][0]
    assert init[0] == 3.5 and init[5] == 2.0
    assert init[3] == 3 and init[4] == 5
    run = by_name["task.run"][0]
    assert run[0] == 5.5 and run[5] == pytest.approx(4.5)
    assert by_name["task.ok"][0][0] == 10.0
    return tr.events()


def test_tracer_task_attempt_spans():
    twin(PAIR, _attempt_spans)


def _requeue_closes(p):
    tr = p.obs.Tracer()
    tr.task_queued("t0", 1, ts=0.0)
    tr.task_requeue("t0", 1, now=50.0, since=10.0)
    spans = [e for e in tr.events() if e[1] == "X" and e[2] == "task.queued"]
    assert len(spans) == 1
    assert spans[0][0] == 0.0 and spans[0][5] == 10.0
    inst = [e for e in tr.events() if e[2] == "task.requeue"][0]
    assert inst[0] == 50.0 and inst[6]["since"] == 10.0
    return tr.events()


def test_tracer_requeue_closes_queued_span_at_dispatch_mark():
    twin(PAIR, _requeue_closes)


def _lost_closes(p):
    tr = p.obs.Tracer()
    tr.task_queued("t0", 1, ts=0.0)
    tr.task_queued("t0", 2, ts=5.0)
    tr.task_lost("t0", now=20.0)
    spans = [e for e in tr.events() if e[1] == "X"]
    assert sorted((s[0], s[0] + s[5]) for s in spans) == \
        [(0.0, 20.0), (5.0, 20.0)]
    assert any(e[2] == "task.lost" for e in tr.events())
    return tr.events()


def test_tracer_lost_closes_all_pending_queue_entries():
    twin(PAIR, _lost_closes)


def _ring_drops(p):
    tr = p.obs.Tracer(capacity=8)
    for i in range(20):
        tr.instant("tick", ts=float(i))
    assert len(tr.events()) == 8
    assert tr.n_dropped == 12
    assert tr.events()[0][0] == 12.0
    return tr.events(), tr.n_dropped


def test_tracer_ring_buffer_drops_oldest_events():
    twin(PAIR, _ring_drops)


class _FakeAlloc:
    def __init__(self, aid, submit_t, ready_t, end_t, state, virtual=False):
        self.alloc_id = aid
        self.submit_t = submit_t
        self.ready_t = ready_t
        self.end_t = end_t
        self.state = state
        self.virtual = virtual


def _alloc_backfill(p):
    tr = p.obs.Tracer()
    a = _FakeAlloc(3, submit_t=1.0, ready_t=4.0, end_t=None, state="running")
    tr.alloc_state(a)
    tr.alloc_state(a)
    evs = tr.events()
    assert [(e[1], e[2]) for e in evs] == [
        ("B", "alloc.queued"), ("E", "alloc.queued"), ("B", "alloc.running")]
    assert evs[0][0] == 1.0 and evs[1][0] == 4.0 and evs[2][0] == 4.0
    a.state, a.end_t = "expired", 9.0
    tr.alloc_state(a, ts=9.0)
    tail = tr.events()[-2:]
    assert [(e[1], e[2]) for e in tail] == [("E", "alloc.running"),
                                            ("i", "alloc.expired")]
    return tr.events()


def test_alloc_state_backfills_history_and_dedups():
    twin(PAIR, _alloc_backfill)


def _chrome_export(p, tmp):
    d = tmp / p.name
    d.mkdir()
    tr = p.obs.Tracer()
    tr.alloc_state(_FakeAlloc(0, submit_t=0.0, ready_t=0.0, end_t=None,
                              state="running"))
    tr.task_queued("t0", 1, ts=0.0)
    tr.task_attempt("t0", 0, 0, 1.0, 1.1, 0.5, 4.0, 1, "ok")
    obj = tr.to_chrome()
    assert p.obs.validate_chrome_trace(obj) == []
    assert obj["traceEvents"][0]["ph"] == "M"
    tr.write_chrome(str(d / "trace.json"))
    assert p.obs.validate_chrome_trace(
        json.loads((d / "trace.json").read_text())) == []
    tr.write_jsonl(str(d / "trace.jsonl"))
    rows = [json.loads(line)
            for line in (d / "trace.jsonl").read_text().splitlines()]
    assert len(rows) == len(tr.events())
    assert all("ts" in r and "ph" in r and "name" in r for r in rows)
    return obj, (d / "trace.json").read_text(), rows


def test_chrome_export_schema_and_validator(tmp_path):
    obj, _, _ = twin(PAIR, _chrome_export, tmp_path)
    # the port's Chrome trace passes the reference's validator
    assert jobs.validate_chrome_trace(obj) == []


def _validator_flags(p):
    bad = {"traceEvents": [
        {"name": "x", "ph": "Q", "ts": 0, "pid": 0, "tid": 0},
        {"name": "y", "ph": "X", "ts": float("nan"), "pid": 0, "tid": 0},
        {"name": "z", "ph": "X", "ts": 5.0, "dur": -1.0, "pid": 0,
         "tid": 0},
        {"name": "w", "ph": "i", "ts": 1.0, "pid": 0, "tid": 0},
        {"name": "v", "ph": "E", "ts": 6.0, "pid": 0, "tid": 0},
    ]}
    probs = p.obs.validate_chrome_trace(bad)
    for want in ("unknown phase", "bad ts", "bad X dur", "non-monotone",
                 "E without open B"):
        assert any(want in q for q in probs), want
    empty = p.obs.validate_chrome_trace({"nope": 1})
    assert empty == ["no traceEvents list"]
    return probs, empty


def test_validator_flags_malformed_traces():
    twin(PAIR, _validator_flags)


def _span_sequence(p):
    t1, t2 = p.obs.Tracer(), p.obs.Tracer()
    t1.instant("a", ts=1.0)
    t1.instant("b", ts=1.0, args={"k": 2})
    t2.instant("b", ts=1.0, args={"k": 2})
    t2.instant("a", ts=1.0)
    assert p.obs.span_sequence(t1) == p.obs.span_sequence(t2)
    return p.obs.span_sequence(t1)


def test_span_sequence_is_order_insensitive():
    twin(PAIR, _span_sequence)


def _histogram(p):
    h = p.obs.Histogram(edges=(0.0, 1.0, 2.0))
    for v in (-5.0, 0.5, 1.5, 99.0):
        h.observe(v)
    assert h.counts == [2, 2]
    assert h.n == 4
    assert h.mean == pytest.approx((-5.0 + 0.5 + 1.5 + 99.0) / 4)
    with pytest.raises(ValueError):
        p.obs.Histogram(edges=(1.0,))
    return h.counts, h.n, h.mean


def test_histogram_bucketing_and_clamping():
    twin(PAIR, _histogram)


def _timeseries(p):
    reg = p.obs.MetricsRegistry(max_samples=8)
    reg.set_gauge("depth", 3.0)
    reg.sample(0.0)
    reg.inc("pops")
    reg.observe("wait", 0.2)
    reg.set_gauge("depth", 1.0)
    reg.sample(1.0)
    ts = reg.timeseries()
    assert ts["t"] == [0.0, 1.0]
    assert ts["depth"] == [3.0, 1.0]
    assert math.isnan(ts["pops"][0]) and ts["pops"][1] == 1.0
    assert math.isnan(ts["wait_mean"][0])
    assert ts["wait_mean"][1] == pytest.approx(0.2)
    snap = reg.snapshot()
    assert snap["counters"] == {"pops": 1.0}
    assert snap["histograms"]["wait"]["n"] == 1
    assert snap["n_samples"] == 2
    return ts, snap


def test_registry_timeseries_alignment_and_nan_fill():
    twin(PAIR, _timeseries)


def _sample_buffer(p):
    reg = p.obs.MetricsRegistry(max_samples=4)
    for i in range(10):
        reg.sample(float(i))
    assert reg.n_samples == 4
    assert reg.timeseries()["t"] == [6.0, 7.0, 8.0, 9.0]
    return reg.timeseries()


def test_registry_sample_buffer_is_bounded():
    twin(PAIR, _sample_buffer)


def _capacity_intervals(p):
    events = [
        (0.0, "B", "alloc.running", 1, 0, 0.0, {"alloc": 0,
                                                "virtual": False}),
        (5.0, "E", "alloc.running", 1, 0, 0.0, None),
        (3.0, "B", "alloc.running", 2, 0, 0.0, {"alloc": 1,
                                                "virtual": False}),
        (8.0, "E", "alloc.running", 2, 0, 0.0, None),
        (0.0, "B", "alloc.running", 9, 0, 0.0, {"alloc": 8,
                                                "virtual": True}),
        (20.0, "B", "alloc.running", 3, 0, 0.0, {"alloc": 2,
                                                 "virtual": False}),
        (25.0, "i", "task.ok", 0, 0, 0.0, {"task": "t9"}),
    ]
    out = p.obs.capacity_intervals(events)
    assert out == [(0.0, 8.0), (20.0, 25.0)]
    return out


def test_capacity_intervals_merge_and_ignore_virtual():
    twin(PAIR, _capacity_intervals)


def _attribution_split(p):
    events = [
        (0.0, "B", "alloc.running", 1, 0, 0.0, {"alloc": 0,
                                                "virtual": False}),
        (4.0, "E", "alloc.running", 1, 0, 0.0, None),
        (2.0, "X", "task.queued", 0, 0, 8.0, {"task": "a", "attempt": 1}),
        (10.0, "X", "task.dispatch", 0, 0, 0.5, {"task": "a",
                                                 "attempt": 1}),
        (10.5, "X", "task.init", 2, 0, 1.5, {"task": "a", "attempt": 1}),
        (30.0, "i", "task.requeue", 0, 0, 0.0, {"task": "a",
                                                "attempt": 1,
                                                "since": 25.0}),
        (40.0, "i", "task.ok", 0, 0, 0.0, {"task": "a"}),
    ]
    out = p.obs.attribute_overhead(events)
    bd = out["per_task"]["a"]
    assert bd.queue_wait_s == pytest.approx(2.0)
    assert bd.alloc_wait_s == pytest.approx(6.0)
    assert bd.dispatch_s == pytest.approx(0.5)
    assert bd.retry_s == pytest.approx(5.0)
    assert bd.init_s == pytest.approx(1.5)
    assert bd.status == "ok"
    assert bd.overhead_s == pytest.approx(2.0 + 6.0 + 0.5 + 5.0)
    assert out["totals"]["overhead_s"] == pytest.approx(bd.overhead_s)
    text = p.obs.format_breakdown(out)
    assert "queue_wait_s" in text and "not overhead" in text
    return out, text


def test_attribution_splits_queue_wait_by_capacity():
    twin(PAIR, _attribution_split)


def _kill_cfg(p):
    return p.cluster.AutoAllocConfig(
        workers_per_alloc=2, walltime_s=60.0, backlog_high_s=30.0,
        backlog_low_s=5.0, max_pending=2, max_allocations=4,
        min_allocations=0, idle_drain_s=20.0, hysteresis_s=5.0)


def _attribution_exact(p):
    tr = p.obs.Tracer()
    res = p.cluster.simulate_cluster(
        p.core.backends.get("hq"),
        p.cluster.bursty_trace(n_bursts=2, burst_size=10, seed=3),
        autoalloc=_kill_cfg(p), max_attempts=6, seed=3, tracer=tr)
    att = res.overhead_attribution
    assert att is not None and att["n_tasks"] == len(res.records)
    rec_by = {r.task_id: r for r in res.records}
    assert any(r.attempts > 1 for r in res.records)
    for tid, bd in att["per_task"].items():
        assert bd.overhead_s == pytest.approx(rec_by[tid].overhead,
                                              abs=1e-9), tid
    assert p.obs.validate_chrome_trace(tr.to_chrome()) == []
    return att, res.records


def test_attribution_matches_task_record_overhead_exactly():
    twin(PAIR, _attribution_exact)


def _untraced(p):
    res = p.cluster.simulate_cluster(
        p.core.backends.get("hq"),
        p.cluster.bursty_trace(n_bursts=1, burst_size=4, seed=0))
    assert res.overhead_attribution is None
    return res.records


def test_untraced_sim_has_no_attribution():
    twin(PAIR, _untraced)


# ==========================================================================
# tests/test_metrics.py
# ==========================================================================
STAT_KEYS = ("min", "q1", "median", "q3", "max", "mean")


def _stats_empty(p):
    s = p.metrics._stats([])
    assert s == {k: 0.0 for k in STAT_KEYS}
    return s


def test_stats_empty_is_all_zero():
    twin(PAIR, _stats_empty)


def _stats_single(p):
    s = p.metrics._stats([7.0])
    assert all(s[k] == 7.0 for k in STAT_KEYS)
    return s


def test_stats_single_sample_every_quantile_collapses():
    twin(PAIR, _stats_single)


def _stats_two(p):
    s = p.metrics._stats([0.0, 1.0])
    assert s["min"] == 0.0 and s["max"] == 1.0
    assert [s["q1"], s["median"], s["q3"], s["mean"]] == \
        pytest.approx([0.25, 0.5, 0.75, 0.5])
    return s


def test_stats_two_samples_interpolate_linearly():
    twin(PAIR, _stats_two)


def _stats_order(p):
    s = p.metrics._stats([3.0, 1.0, 2.0])
    assert s == p.metrics._stats([1.0, 2.0, 3.0])
    return s


def test_stats_is_order_insensitive():
    twin(PAIR, _stats_order)


NAN = float("nan")


def _never_granted(p):
    rec = p.metrics.AllocationRecord(alloc_id=0, n_workers=4, submit_t=10.0,
                                     start_t=NAN, end_t=NAN, state="expired")
    assert rec.held_s == 0.0
    assert rec.node_seconds == 0.0
    return rec.held_s, rec.node_seconds


def test_allocation_record_never_granted_holds_zero_node_seconds():
    twin(PAIR, _never_granted)


def _still_held(p):
    rec = p.metrics.AllocationRecord(alloc_id=1, n_workers=2, submit_t=0.0,
                                     start_t=5.0, end_t=NAN)
    assert rec.held_s == 0.0
    return rec.held_s, rec.node_seconds


def test_allocation_record_still_held_reads_as_zero_until_released():
    twin(PAIR, _still_held)


def _node_s_sentinel(p):
    mk = p.metrics.AllocationRecord
    derived = mk(alloc_id=2, n_workers=3, submit_t=0.0, start_t=10.0,
                 end_t=20.0)
    assert derived.node_s == -1.0
    assert derived.node_seconds == pytest.approx(30.0)
    billed = mk(alloc_id=3, n_workers=3, submit_t=0.0, start_t=10.0,
                end_t=20.0, node_s=12.5)
    assert billed.node_seconds == 12.5
    zero = mk(alloc_id=4, n_workers=3, submit_t=0.0, start_t=10.0,
              end_t=20.0, node_s=0.0)
    assert zero.node_seconds == 0.0
    return derived.node_seconds, billed.node_seconds, zero.node_seconds


def test_allocation_record_node_s_sentinel_vs_billed():
    twin(PAIR, _node_s_sentinel)


def _negative_held(p):
    rec = p.metrics.AllocationRecord(alloc_id=5, n_workers=2, submit_t=0.0,
                                     start_t=20.0, end_t=10.0)
    assert rec.held_s == 0.0
    return rec.held_s


def test_allocation_record_negative_held_clamps_to_zero():
    twin(PAIR, _negative_held)


def _sd_hist_empty(p):
    h = p.metrics.sd_histogram([])
    assert h == {"edges": [], "counts": []}
    return h


def test_sd_histogram_empty():
    twin(PAIR, _sd_hist_empty)


def _sd_hist_single(p):
    h = p.metrics.sd_histogram([0.3, 0.3, 0.3], n_bins=4)
    assert len(h["edges"]) == 5 and len(h["counts"]) == 4
    assert sum(h["counts"]) == 3.0
    assert h["edges"][0] == pytest.approx(0.3)
    assert h["edges"][-1] > h["edges"][0]
    assert all(b >= a for a, b in zip(h["edges"], h["edges"][1:]))
    return h


def test_sd_histogram_single_value_degenerate_range():
    twin(PAIR, _sd_hist_single)


def _sd_hist_partition(p):
    xs = [0.0, 0.1, 0.2, 0.5, 1.0]
    h = p.metrics.sd_histogram(xs, n_bins=5)
    assert sum(h["counts"]) == float(len(xs))
    assert h["counts"][-1] >= 1.0
    return h


def test_sd_histogram_counts_partition_the_samples():
    twin(PAIR, _sd_hist_partition)


def _overhead_clamp(p):
    r = p.metrics.TaskRecord(task_id="t", submit_t=0.0, start_t=0.0,
                             end_t=5.0, cpu_time=9.0, compute_t=9.0)
    assert r.overhead == 0.0
    return r.overhead


def test_task_record_overhead_clamps_at_zero():
    twin(PAIR, _overhead_clamp)


def _overhead_positive(p):
    r = p.metrics.TaskRecord(task_id="t", submit_t=0.0, start_t=3.0,
                             end_t=10.0, cpu_time=6.0, compute_t=5.0)
    assert r.overhead == pytest.approx(4.0)
    return r.overhead


def test_task_record_overhead_positive_case():
    twin(PAIR, _overhead_positive)


def _killed_record(p):
    r = p.metrics.killed_task_record("t9", submit_t=2.0, now=50.0,
                                     alloc_id=3, attempts=4)
    assert r.start_t == r.end_t == 50.0
    assert r.cpu_time == 0.0 and r.compute_t == 0.0
    assert r.worker == "alloc3" and r.status == "failed"
    assert r.attempts == 4
    assert r.overhead == pytest.approx(48.0)
    return r, r.overhead


def test_killed_task_record_canonical_shape():
    twin(PAIR, _killed_record)


# ==========================================================================
# tests/test_offload.py
# ==========================================================================
TOL = 1e-4


def _analytic_1pt(p):
    """The hand-built one-point posterior of tests/test_offload.py, with
    each package's own `GPParams.init(1)` (the port's takes its device
    from the package setting, here the CPU)."""
    params = p.gp.GPParams.init(1)
    sf, s2 = 1.0, 0.01
    k11 = sf + s2 + 1e-5 * (sf + 1.0)
    arr = p.array
    y_std = arr([1.0, 10.0])
    alpha = arr([[1.0, 1.0]]) / k11
    post = p.gp.GPPosterior(params=params, x=arr([[0.0]]),
                            y=arr([[1.0, 10.0]]), y_mean=arr([0.0, 0.0]),
                            y_std=y_std, chol=arr([[np.sqrt(k11)]]),
                            alpha=alpha)
    return post, sf, k11


@pytest.mark.parametrize("fn", ["predict", "predict_batch"])
def test_multioutput_variance_matches_analytic_1pt(fn):
    """Per-output variance against the closed form, each package on its
    own `GPParams.init(1)`; the port within 1e-4 of the reference."""
    xs = np.array([[0.0], [0.7]], np.float32)
    out = {}
    for p in PAIR:
        post, sf, k11 = _analytic_1pt(p)
        mean, var = getattr(p.gp, fn)(post, xs)
        assert tuple(mean.shape) == (2, 2) and tuple(var.shape) == (2, 2)
        kstar = np.exp(-0.5 * xs[:, 0] ** 2)
        latent = np.maximum(sf - kstar ** 2 / k11, 1e-12)
        np.testing.assert_allclose(
            np32(var), latent[:, None] * np.array([1.0, 100.0])[None, :],
            rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(
            np32(mean), (kstar / k11)[:, None] * np.array([1.0, 10.0])[None],
            rtol=1e-4, atol=1e-6)
        out[p.name] = (np32(mean), np32(var))
    for a, b in zip(out["repro"], out["repro_torch"]):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=1e-6)


def _draws(kind):
    """(generator, inputs): the seeded inputs of tests/test_offload.py's
    three fits, the generator left where the reference test goes on."""
    rng = np.random.default_rng(2 if kind == "bucket" else 0)
    shape = {"toy": (40, 2), "scaled": (20, 2), "bucket": (24, 3)}[kind]
    return rng, rng.random(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ref_fit(kind):
    """The reference's fits of tests/test_offload.py, once per module:
    `_toy_surrogate`'s, the y2 = 100 y1 case and the bucket-shape case."""
    _, xs = _draws(kind)
    if kind == "toy":
        ys = np.stack([np.sin(3 * xs[:, 0]) + xs[:, 1],
                       100.0 * np.cos(2 * xs[:, 1])], 1)
    elif kind == "scaled":
        y1 = np.sin(3 * xs[:, 0]) + xs[:, 1]
        ys = np.stack([y1, 100.0 * y1], 1)
    else:
        ys = np.stack([np.sin(2 * xs[:, 0]), xs[:, 1] - xs[:, 2]], 1)
    return jgp.fit(xs, ys, steps={"toy": 80, "scaled": 60, "bucket": 40}[kind])


def _post(p, kind):
    """Package p's posterior: the reference's fit, carried across for the
    port."""
    jpost = _ref_fit(kind)
    if p is J:
        return jpost
    return tgp.posterior_from_numpy(export_posterior(jpost), "cpu")


def test_multioutput_variance_scales_per_output_after_fit():
    out = []
    for p in PAIR:
        rng, _ = _draws("scaled")
        _, var = p.gp.predict(_post(p, "scaled"),
                              rng.random((5, 2)).astype(np.float32))
        np.testing.assert_allclose(np32(var)[:, 1], 1e4 * np32(var)[:, 0],
                                   rtol=1e-4)
        out.append(np32(var))
    np.testing.assert_allclose(out[1] / 1e4, out[0] / 1e4, rtol=TOL,
                               atol=1e-6)


def _flatten(p):
    f = p.predictor.flatten_parameters
    got = [f([]), f([[]]), f(((),)), f([[1.0, 2.0]]), f("nope")]
    assert got == [None, None, None, [1.0, 2.0], None]
    return got


def test_flatten_parameters_empty_is_none():
    twin(PAIR, _flatten)


def test_gp_predictor_not_poisoned_by_empty_payload(monkeypatch):
    """Both predictors skip the empty payloads and fit on the real ones;
    the port (installing the reference's fit) estimates what the
    reference does at 1e-4."""
    carry_reference_fit(monkeypatch)
    est = []
    for p in PAIR:
        pred = p.sched.GPRuntimePredictor(min_fit=4, fit_steps=20)
        empty = p.core.EvalRequest("m", [[]])
        for _ in range(3):
            pred.observe(empty, 1.0)
        assert pred._dim is None
        rng = np.random.default_rng(1)
        for _ in range(6):
            pred.observe(p.core.EvalRequest("m", [rng.random(2).tolist()]),
                         2.0)
        assert pred._dim == 2
        assert pred._post is not None
        e = pred.predict(p.core.EvalRequest("m", [rng.random(2).tolist()]))
        assert e == pytest.approx(2.0, rel=0.5)
        est.append(e)
    assert est[1] == pytest.approx(est[0], rel=TOL)


def _stuff_results(p, ex, model, n, compute_t):
    for i in range(n):
        tid = f"{model}-{i}"
        ex._requests[tid] = p.core.EvalRequest(model, [[0.0]], task_id=tid)
        ex._results[tid] = p.core.EvalResult(task_id=tid, status="ok",
                                             compute_t=compute_t)


def _straggler_per_model(p):
    with p.core.Executor({}, n_workers=0, straggler_factor=3.0,
                         straggler_min_completed=3) as ex:
        with ex._lock:
            _stuff_results(p, ex, "fast", 60, 0.01)
            _stuff_results(p, ex, "slow", 3, 1.0)
            now = time.monotonic()
            slow_run = p.core.EvalRequest("slow", [[0.0]], task_id="slow-run")
            fast_run = p.core.EvalRequest("fast", [[0.0]], task_id="fast-run")
            ex._running["slow-run"] = (slow_run, None, now - 0.5, 1)
            ex._running["fast-run"] = (fast_run, None, now - 0.5, 1)
        ex._straggler_check(now)
        flags = [bool(fast_run.config.get("_speculated")),
                 bool(slow_run.config.get("_speculated"))]
        assert flags == [True, False]
        return flags


def test_straggler_threshold_is_per_model():
    twin(PAIR, _straggler_per_model)


def _straggler_pooled(p):
    with p.core.Executor({}, n_workers=0, straggler_factor=3.0,
                         straggler_min_completed=3) as ex:
        with ex._lock:
            _stuff_results(p, ex, "fast", 10, 0.01)
            now = time.monotonic()
            new_run = p.core.EvalRequest("new-model", [[0.0]],
                                         task_id="new-run")
            ex._running["new-run"] = (new_run, None, now - 0.5, 1)
        ex._straggler_check(now)
        assert new_run.config.get("_speculated")
        return bool(new_run.config.get("_speculated"))


def test_straggler_pooled_fallback_for_unknown_model():
    twin(PAIR, _straggler_pooled)


def test_predict_batch_bucket_shape_discipline():
    """The port's bucketed predict on the reference's posterior: at most
    three accounted shapes over a queue's lifetime, and every batch
    within 1e-4 of the reference's."""
    jpost, tpost = _post(J, "bucket"), _post(T, "bucket")
    rng, _ = _draws("bucket")
    tgp.predict_batch_shapes.clear()
    total = 0
    for size in (1, 2, 9, 40, 64, 65, 131, 300, 512):
        xs = rng.random((size, 3)).astype(np.float32)
        mean_b, var_b = tgp.predict_batch(tpost, xs)
        assert tuple(mean_b.shape) == (size, 2) == tuple(var_b.shape)
        jm, jv = jgp.predict_batch(jpost, xs)
        np.testing.assert_allclose(np32(mean_b), np32(jm), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(np32(var_b), np32(jv), rtol=TOL,
                                   atol=TOL)
        total += size
    assert total >= 512
    assert len(tgp.predict_batch_shapes) <= 3
    xs = rng.random((37, 3)).astype(np.float32)
    mean_b, var_b = tgp.predict_batch(tpost, xs)
    mean_p, var_p = tgp.predict(tpost, xs)
    np.testing.assert_allclose(np32(mean_b), np32(mean_p), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np32(var_b), np32(var_p), rtol=5e-2,
                               atol=1e-6)


def _toy_surrogate(p, **kw):
    post = _post(p, "toy")
    kw.setdefault("runtime_budget_s", 30.0)
    kw.setdefault("sd_threshold", 0.2)
    return p.sched.SurrogateOffload(post, **kw)


def _stats_of(sur):
    st_ = sur.stats()
    return st_.n_considered, st_.n_offloaded, \
        round(st_.cpu_seconds_avoided, 9), sum(st_.sd_histogram["counts"])


def _gates(p):
    sur = _toy_surrogate(p)
    mk = p.core.EvalRequest
    trusted_long = mk("m", [[0.5, 0.5]], time_request=100.0)
    trusted_short = mk("m", [[0.5, 0.5]], time_request=1.0)
    untrusted_long = mk("m", [[5.0, 5.0]], time_request=100.0)
    unflat_long = mk("m", [["x"]], time_request=100.0)
    got = [sur.decide(trusted_long, cost=100.0),
           sur.decide(trusted_short, cost=1.0),
           sur.decide(untrusted_long, cost=100.0),
           sur.decide(unflat_long, cost=100.0)]
    assert got == [True, False, False, False]
    assert trusted_long.config.get("_surrogate") is True
    st_ = sur.stats()
    assert st_.n_considered == 4 and st_.n_offloaded == 1
    assert st_.cpu_seconds_avoided > 0
    assert sum(st_.sd_histogram["counts"]) == 2
    stats = _stats_of(sur)
    assert not sur.decide(trusted_long, cost=1.0)
    assert "_surrogate" not in trusted_long.config
    return got, stats


def test_offload_gates():
    twin(PAIR, _gates)


def _scoped(p):
    sur = _toy_surrogate(p, model_name="gs2")
    other = p.core.EvalRequest("other", [[0.5, 0.5]], time_request=100.0)
    mine = p.core.EvalRequest("gs2", [[0.5, 0.5]], time_request=100.0)
    got = [sur.decide(other, cost=100.0), sur.decide(mine, cost=100.0)]
    assert got == [False, True]
    n_before = int(sur.posterior.x.shape[0])
    sur.condition_every = 1
    sur.observe([[0.5, 0.5]], [[1.0, 1.0]], model_name="other")
    assert int(sur.posterior.x.shape[0]) == n_before
    sur.observe([[0.5, 0.5]], [[1.0, 1.0]], model_name="gs2")
    assert int(sur.posterior.x.shape[0]) == n_before + 1
    return got, n_before


def test_offload_scoped_to_model():
    twin(PAIR, _scoped)


def _no_surrogate_pin(p):
    sur = _toy_surrogate(p)
    req = p.core.EvalRequest("m", [[0.5, 0.5]], time_request=100.0)
    got = [sur.decide(req, cost=100.0)]
    req.config["_no_surrogate"] = True
    got.append(sur.decide(req, cost=100.0))
    assert got == [True, False]
    assert "_surrogate" not in req.config
    return got


def test_offload_no_surrogate_pin():
    twin(PAIR, _no_surrogate_pin)


def _credit_idempotent(p):
    sur = _toy_surrogate(p)
    req = p.core.EvalRequest("m", [[0.5, 0.5]], time_request=100.0)
    assert sur.decide(req, cost=100.0)
    assert sur.decide(req, cost=100.0)
    st_ = sur.stats()
    assert st_.n_offloaded == 1
    assert st_.cpu_seconds_avoided == pytest.approx(100.0 - sur.latency_s)
    first = _stats_of(sur)
    req.config["_no_surrogate"] = True
    assert not sur.decide(req, cost=100.0)
    st_ = sur.stats()
    assert st_.n_offloaded == 0
    assert st_.cpu_seconds_avoided == pytest.approx(0.0)
    return first, _stats_of(sur)


def test_offload_credit_idempotent_across_requeues():
    twin(PAIR, _credit_idempotent)


def _observe_caps(p):
    sur = _toy_surrogate(p, condition_every=1, max_points=42)
    for i in range(6):
        x = 0.01 * i
        sur.observe([[x, x]], [[1.0, 1.0]], model_name=None)
    n = int(sur.posterior.x.shape[0])
    last = float(sur.posterior.x[-1, 0])
    assert n == 42
    assert last == pytest.approx(0.05)
    return n, np32(sur.posterior.x).tolist()


def test_offload_observe_caps_training_set():
    twin(PAIR, _observe_caps)


def _unarmed(p):
    sur = p.sched.SurrogateOffload()
    req = p.core.EvalRequest("m", [[0.5, 0.5]], time_request=1000.0)
    assert not sur.decide(req, cost=1000.0)
    pol = p.sched.SurrogateOffloadPolicy(policy="fcfs", surrogate=sur)
    pol.push(req, 1)
    assert len(pol) == 1 and pol.pop() == (req, 1)
    return len(pol)


def test_offload_unarmed_engine_is_passthrough():
    twin(PAIR, _unarmed)


def _fast_lane(p):
    pol = p.sched.SurrogateOffloadPolicy(policy="fcfs",
                                         surrogate=_toy_surrogate(p))
    normal = p.core.EvalRequest("m", [[5.0, 5.0]], time_request=100.0,
                                task_id="normal")
    offl = p.core.EvalRequest("m", [[0.5, 0.5]], time_request=100.0,
                              task_id="offl")
    pol.push(normal, 1)
    pol.push(offl, 1)
    assert len(pol) == 2
    order = [pol.pop()[0].task_id, pol.pop()[0].task_id]
    assert order == ["offl", "normal"]
    return order


def test_offload_policy_fast_lane():
    twin(PAIR, _fast_lane)


def _offload_trace(p, n=30, seed=7):
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(n):
        t += float(rng.exponential(4.0))
        lng = rng.uniform() < 0.4
        theta = rng.random(2) if rng.uniform() < 0.7 else 3.0 + rng.random(2)
        out.append(p.cluster.TraceTask(
            t=t, runtime=90.0 if lng else 3.0, model_name="gs2",
            time_request=90.0 if lng else 3.0,
            parameters=[[float(theta[0]), float(theta[1])]]))
    return out


def _sim_offload(p):
    trace = _offload_trace(p)
    base = p.cluster.simulate_cluster(p.core.backends.get("hq"), trace,
                                      n_workers=3, seed=0)
    runs = []
    for _ in range(2):
        sur = _toy_surrogate(p, latency_s=0.05)
        broker = p.cluster.Broker(policy="fcfs", surrogate=sur)
        res = p.cluster.simulate_cluster(p.core.backends.get("hq"), trace,
                                         broker=broker, n_workers=3, seed=0)
        runs.append((res, sur))
    (res1, sur1), (res2, sur2) = runs

    def key(r):
        return (r.task_id, r.start_t, r.end_t, r.worker, r.status)
    assert [key(r) for r in res1.records] == [key(r) for r in res2.records]
    assert sur1.stats().n_offloaded == sur2.stats().n_offloaded > 0
    assert res1.summary()["n_ok"] == res1.summary()["n_tasks"]
    offloaded = [r for r in res1.records if r.worker.startswith("alloc0-")]
    assert len(offloaded) == sur1.stats().n_offloaded
    assert all(r.cpu_time == pytest.approx(0.05) for r in offloaded)
    assert p.metrics.total_cpu_time(res1.records) < \
        0.8 * p.metrics.total_cpu_time(base.records)
    virt = [a for a in res1.allocations if a.alloc_id == 0]
    assert virt and virt[0].node_seconds == 0.0
    return res1.records, res1.allocations, _stats_of(sur1)


def test_sim_offload_deterministic_and_saves_cpu():
    twin(PAIR, _sim_offload)


def _offload_autoalloc(p):
    sur = _toy_surrogate(p)
    broker = p.cluster.Broker(policy="fcfs", surrogate=sur)
    res = p.cluster.simulate_cluster(
        p.core.backends.get("hq"), _offload_trace(p, n=20, seed=3),
        broker=broker, autoalloc=p.cluster.AutoAllocConfig(
            workers_per_alloc=2, walltime_s=600.0, backlog_high_s=20.0,
            backlog_low_s=5.0, idle_drain_s=20.0, hysteresis_s=5.0),
        seed=0)
    assert res.summary()["n_ok"] == res.summary()["n_tasks"]
    assert sur.stats().n_offloaded > 0
    assert all(d["alloc_id"] != 0 for d in res.decisions)
    return res.records, res.decisions, _stats_of(sur)


def test_sim_offload_with_autoalloc_ignores_virtual():
    twin(PAIR, _offload_autoalloc)


def _truth(x):
    return [float(np.sin(3 * x[0]) + x[1]), float(100.0 * np.cos(2 * x[1]))]


def _slow_model():
    def fn(parameters, config):
        time.sleep(0.1)
        return [_truth(np.asarray(parameters[0], float))]
    return ttask.LambdaModel("slow", fn, 2, 2)


def test_live_offload_policy_mode():
    """The live offload through `SurrogateOffloadPolicy`, on the port
    with the reference's surrogate: every trusted task served by the GP
    near the truth, the untrusted one run for real."""
    rng = np.random.default_rng(4)
    sur = _toy_surrogate(T, latency_s=0.0)
    pol = tsched.SurrogateOffloadPolicy(policy="fcfs", surrogate=sur)
    with tcore.Executor({"slow": _slow_model}, n_workers=2,
                        policy=pol) as ex:
        trusted = [tcore.EvalRequest("slow", [rng.random(2).tolist()],
                                     time_request=100.0) for _ in range(4)]
        untrusted = [tcore.EvalRequest("slow", [[4.0, 4.0]],
                                       time_request=100.0)]
        res = ex.run_all(trusted + untrusted, timeout=60)
        assert all(r.status == "ok" for r in res)
        assert len([r for r in res if r.worker.endswith("-surrogate")]) == 4
        assert not res[-1].worker.endswith("-surrogate")
        for r, rq in zip(res[:4], trusted):
            want = np.asarray(_truth(np.asarray(rq.parameters[0])))
            err = np.abs(np.asarray(r.value[0]) - want) / np.array([1., 100.])
            assert np.all(err < 0.25), (r.value, want)
        m = ex.metrics()
        assert m["offload"]["n_offloaded"] == 4
        assert m["offload"]["cpu_seconds_avoided"] > 0


def test_live_offload_broker_mode():
    """The live offload through the cluster broker's virtual allocation,
    on the port; the virtual allocation bills nothing."""
    rng = np.random.default_rng(5)
    broker = tcluster.Broker(policy="fcfs",
                             surrogate=_toy_surrogate(T, latency_s=0.0))
    with tcore.Executor({"slow": _slow_model}, n_workers=2,
                        cluster=broker) as ex:
        deadline = time.monotonic() + 5.0
        while ex.n_workers() < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        reqs = [tcore.EvalRequest("slow", [rng.random(2).tolist()],
                                  time_request=100.0) for _ in range(4)]
        reqs += [tcore.EvalRequest("slow", [[4.0, 4.0]], time_request=100.0)]
        res = ex.run_all(reqs, timeout=60)
        assert all(r.status == "ok" for r in res)
        assert len([r for r in res if r.worker.endswith("-surrogate")]) == 4
        virt = [a for a in ex.allocation_records() if a.alloc_id == 0]
        assert virt and virt[0].node_seconds == 0.0


def test_live_offload_virtual_worker_respawns_after_crash():
    """A crashed virtual worker is replaced, on the port."""
    rng = np.random.default_rng(6)
    broker = tcluster.Broker(policy="fcfs",
                             surrogate=_toy_surrogate(T, latency_s=0.0))
    with tcore.Executor({"slow": _slow_model}, n_workers=1,
                        cluster=broker) as ex:
        deadline = time.monotonic() + 5.0
        while ex.n_workers() < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        virt_idx = next(i for i, w in enumerate(ex.workers)
                        if w.alloc is not None and w.alloc.virtual)
        ex.kill_worker(virt_idx)
        res = ex.run_all([tcore.EvalRequest("slow", [rng.random(2).tolist()],
                                            time_request=100.0)
                          for _ in range(3)], timeout=30)
        assert all(r.status == "ok" for r in res)
        assert sum(r.worker.endswith("-surrogate") for r in res) == 3


def test_live_offload_real_runs_condition_surrogate():
    """An untrusted theta runs the real model; its completion conditions
    the port's surrogate (a Cholesky rebuild in the port) until the same
    theta is trusted."""
    sur = _toy_surrogate(T, latency_s=0.0, condition_every=1)
    pol = tsched.SurrogateOffloadPolicy(policy="fcfs", surrogate=sur)
    probe = [2.0, 2.0]
    with tcore.Executor({"slow": _slow_model}, n_workers=1,
                        policy=pol) as ex:
        assert float(sur.trust_sd([probe])[0]) > sur.sd_threshold
        r = ex.run_all([tcore.EvalRequest("slow", [probe],
                                          time_request=100.0)],
                       timeout=60)[0]
        assert r.status == "ok" and not r.worker.endswith("-surrogate")
        deadline = time.monotonic() + 5.0
        while float(sur.trust_sd([probe])[0]) > sur.sd_threshold \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert float(sur.trust_sd([probe])[0]) <= sur.sd_threshold
