"""The port's broker service, crash-safe journal, chaos layer and
fair-share policy against `repro`: twins of tests/test_service.py,
tests/test_chaos.py and tests/test_fairshare.py.

Each twin runs the reference case through both packages (`twin`): the
same inputs, the reference's asserts on each side, and equal
observations.  Where a case is a thread-timing property (a kill after a
share of the tasks, a blocking submit that times out), the port is held
to the same property and the values that do not depend on timing are
compared.  The GP runs only in the predictor cases, which carry the
reference's fit across (`carry_reference_fit`).

Beyond the reference's cases: a journal that the reference's
`ServiceBroker` wrote with `predictor="gp"` is recovered by the port's
with zero lost tasks, its predictor matching the reference's at 1e-4;
and the fair-share recipe of benchmarks/broker_service.py gives equal
shares through both packages' `simulate_cluster`.
"""
import json
import os
import signal
import subprocess
import sys
import time
import types
from collections import Counter

import numpy as np
import pytest

import repro.chaos as jchaos
import repro.checkpoint as jcheckpoint
import repro.cluster as jcluster
import repro.core as jcore
import repro.obs as jobs
import repro.sched as jsched
import repro.service as jservice
import repro_torch.chaos as tchaos
import repro_torch.checkpoint as tcheckpoint
import repro_torch.cluster as tcluster
import repro_torch.core as tcore
import repro_torch.obs as tobs
import repro_torch.sched as tsched
import repro_torch.service as tservice
from hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st
from repro.core import task as jtask
from repro_torch.core import task as ttask
from torch_port_util import carry_reference_fit, on_cpu, twin  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

J = types.SimpleNamespace(name="repro", chaos=jchaos, checkpoint=jcheckpoint,
                          cluster=jcluster, core=jcore, obs=jobs, sched=jsched,
                          service=jservice, task=jtask)
T = types.SimpleNamespace(name="repro_torch", chaos=tchaos,
                          checkpoint=tcheckpoint, cluster=tcluster, core=tcore,
                          obs=tobs, sched=tsched, service=tservice, task=ttask)
PAIR = (J, T)
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _toy(p):
    return p.task.LambdaModel("toy", lambda q, c: [[float(q[0][0]) * 2]], 1, 1)


def _slow(p, dt=0.05):
    def fn(q, c):
        time.sleep(dt)
        return [[float(q[0][0])]]
    return p.task.LambdaModel("toy", fn, 1, 1)


def _req(p, i, tenant="a", **kw):
    return p.core.EvalRequest("toy", [[float(i)]], time_request=1.0,
                              time_limit=30.0, tenant=tenant, **kw)


def _files(d):
    return {f.name: f.read_text() for f in sorted(d.iterdir())}


# --------------------------------------------------------------------------
# journal
# --------------------------------------------------------------------------
def _journal_write_load_latest(p, tmp):
    d = tmp / p.name
    j = p.checkpoint.Journal(d, keep=3)
    for i in range(5):
        j.write({"i": i})
    assert j.seqs() == [3, 4, 5]
    assert j.latest() == (5, {"i": 4})
    assert j.load(3) == {"i": 2}
    return j.seqs(), j.latest(), j.load(3), _files(d)


def test_journal_write_load_latest(tmp_path):
    """Same sequence, same state, and byte-equal journal files."""
    twin(PAIR, _journal_write_load_latest, tmp_path)


def _journal_skips_corrupt_latest(p, tmp):
    d = tmp / p.name
    j = p.checkpoint.Journal(d, keep=5)
    j.write({"good": 1})
    j.write({"good": 2})
    (d / "journal_00000003.json").write_text('{"seq": 3, "sta')
    assert j.latest() == (2, {"good": 2})
    j2 = p.checkpoint.Journal(d, keep=5)
    j2.write({"good": 3})
    assert j2.latest() == (4, {"good": 3})
    return j.latest(), j2.seqs(), _files(d)


def test_journal_skips_corrupt_latest(tmp_path):
    twin(PAIR, _journal_skips_corrupt_latest, tmp_path)


def _journal_no_tmp_debris(p, tmp):
    d = tmp / p.name
    j = p.checkpoint.Journal(d, keep=2)
    j.write({"x": [1, 2, 3]})
    assert [f.name for f in d.iterdir()] == ["journal_00000001.json"]
    with pytest.raises(TypeError):
        j.write({"bad": object()})
    assert [f.name for f in d.iterdir()] == ["journal_00000001.json"]
    assert j.latest() == (1, {"x": [1, 2, 3]})
    return _files(d)


def test_journal_no_tmp_debris(tmp_path):
    twin(PAIR, _journal_no_tmp_debris, tmp_path)


@pytest.mark.skipif(sys.platform == "win32", reason="POSIX signals")
def test_journal_survives_sigkill_mid_write(tmp_path):
    """The port's journal SIGKILLed mid-stream: the newest loadable
    journal always parses with consistent state, and the reference's
    `Journal` reads the same directory to the same (seq, state)."""
    script = r"""
import sys
sys.path.insert(0, %r)
from repro_torch.checkpoint import Journal
j = Journal(%r, keep=3)
i = j.latest_seq() or 0
while True:
    i += 1
    j.write({"seq_echo": i, "n": [i] * 2000})
""" % (SRC, str(tmp_path))
    for round_no in range(4):
        proc = subprocess.Popen([sys.executable, "-c", script],
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        deadline = time.monotonic() + 10.0
        j = tcheckpoint.Journal(tmp_path, keep=3)
        while j.latest_seq() is None or j.latest_seq() < 2 * (round_no + 1):
            if time.monotonic() > deadline:
                break
            time.sleep(0.005)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        loaded = tcheckpoint.Journal(tmp_path, keep=3).latest()
        assert loaded is not None, "no loadable journal after SIGKILL"
        seq, state = loaded
        assert state["n"] == [state["seq_echo"]] * 2000
        assert jcheckpoint.Journal(tmp_path, keep=3).latest() == loaded
    for f in tmp_path.iterdir():
        if f.suffix == ".tmp":
            continue
        assert f.name.startswith("journal_")


# --------------------------------------------------------------------------
# predictor persistence
# --------------------------------------------------------------------------
def _quantile_roundtrip(p):
    q = p.sched.QuantileEstimator(window=16)
    for i in range(10):
        q.observe(_req(p, i, tenant="default"), compute_t=float(i + 1))
    state = q.state_dict()
    assert json.loads(json.dumps(state)) == state
    q2 = p.sched.QuantileEstimator(window=16)
    q2.load_state(state)
    r = _req(p, 99)
    assert q2.predict(r) == q.predict(r)
    assert q2.quantile(0.95, "toy") == q.quantile(0.95, "toy")
    return state, q2.predict(r), q2.quantile(0.95, "toy")


def test_quantile_estimator_state_roundtrip():
    _, pred, p95 = twin(PAIR, _quantile_roundtrip)
    jq = jsched.QuantileEstimator(window=16)   # the reference's state...
    for i in range(10):
        jq.observe(_req(J, i, tenant="default"), compute_t=float(i + 1))
    q = tsched.QuantileEstimator(window=16)    # ...read by the port
    q.load_state(json.loads(json.dumps(jq.state_dict())))
    assert (q.predict(_req(T, 99)), q.quantile(0.95, "toy")) == (pred, p95)


QUERIES = [[float(x)] for x in np.linspace(-1.0, 7.0, 33)]


def _gp_roundtrip(p):
    gp = p.sched.GPRuntimePredictor(min_fit=4, fit_steps=5,
                                    backend="incremental")
    for i in range(6):
        gp.observe(_req(p, i), compute_t=0.5 + 0.1 * i)
    state = gp.state_dict()
    assert state["backend"] == "incremental"
    assert json.loads(json.dumps(state)) == state
    gp2 = p.sched.GPRuntimePredictor(min_fit=4, fit_steps=5)
    gp2.load_state(state)
    assert gp2.backend == "incremental"
    assert gp2.n_observed("toy") == gp.n_observed("toy")
    p1, p2 = gp.predict(_req(p, 3)), gp2.predict(_req(p, 3))
    assert p1 is not None and p2 is not None
    assert p2 == pytest.approx(p1, rel=0.2)
    return state, gp2


def _reqs(p, rows):
    return [p.core.EvalRequest("toy", [row]) for row in rows]


def test_gp_predictor_state_roundtrip(monkeypatch):
    """The round trip on each side; the states equal; and the reference's
    state carried into a port predictor predicts what the reference's
    restored predictor does, at 1e-4 (relative, on seconds)."""
    carry_reference_fit(monkeypatch)
    jstate, jgp2 = _gp_roundtrip(J)
    tstate, _ = _gp_roundtrip(T)
    assert jstate == tstate
    tgp3 = tsched.GPRuntimePredictor(min_fit=4, fit_steps=5)
    tgp3.load_state(json.loads(json.dumps(jstate)))
    assert tgp3.backend == "incremental"
    np.testing.assert_allclose(
        [tgp3.predict(r) for r in _reqs(T, QUERIES)],
        [jgp2.predict(r) for r in _reqs(J, QUERIES)], rtol=1e-4)
    np.testing.assert_allclose(tgp3.predict_many(_reqs(T, QUERIES)),
                               jgp2.predict_many(_reqs(J, QUERIES)),
                               rtol=1e-4)


def _snapshot_carries_predictor(p):
    def pred():
        return p.sched.GPRuntimePredictor(min_fit=4, fit_steps=5,
                                          backend="incremental")
    ex = p.core.Executor({"toy": lambda: _toy(p)}, n_workers=1,
                         predictor=pred())
    ex.run_all([_req(p, i, tenant="t1", task_id=f"s{i}") for i in range(5)])
    snap = ex.snapshot()
    ex.shutdown()
    assert snap["predictor"] is not None
    assert snap["predictor"]["backend"] == "incremental"
    ex2 = p.core.Executor.restore(
        snap, {"toy": lambda: _toy(p)}, n_workers=1,
        predictor=p.sched.GPRuntimePredictor(min_fit=4, fit_steps=5))
    try:
        assert ex2.predictor.backend == "incremental"
        assert ex2.predictor.n_observed("toy") == 5
    finally:
        ex2.shutdown()
    # the runtimes (ys) are measured, so they are not compared
    return ({k: snap["predictor"][k]
             for k in ("kind", "backend", "dim", "xs", "n_fits")},
            snap["completed"])


def test_executor_snapshot_carries_predictor_and_tenant(monkeypatch):
    carry_reference_fit(monkeypatch)
    twin(PAIR, _snapshot_carries_predictor)


def _snapshot_pending_tenant(p):
    ex = p.core.Executor({"toy": lambda: _toy(p)}, n_workers=0)
    ex.submit(_req(p, 0, tenant="vip", task_id="pending-0"))
    snap = ex.snapshot()
    ex.shutdown()
    assert snap["pending"][0]["tenant"] == "vip"
    assert p.core.EvalRequest(**snap["pending"][0]).tenant == "vip"
    return snap["pending"]


def test_snapshot_pending_records_tenant():
    pending = twin(PAIR, _snapshot_pending_tenant)
    # a pending payload written by either package builds the other's
    assert jcore.EvalRequest(**pending[0]).tenant == "vip"


# --------------------------------------------------------------------------
# labelled metrics
# --------------------------------------------------------------------------
def _labeled_series(p):
    reg = p.obs.MetricsRegistry()
    reg.inc("tasks_submitted", labels={"tenant": "a"})
    reg.inc("tasks_submitted", v=2.0, labels={"tenant": "b"})
    reg.inc("tasks_submitted")
    assert reg.counters["tasks_submitted{tenant=a}"] == 1.0
    assert reg.counters["tasks_submitted{tenant=b}"] == 2.0
    assert reg.counters["tasks_submitted"] == 1.0
    reg.set_gauge("queue_depth", 7.0, labels={"tenant": "a"})
    assert reg.gauges["queue_depth{tenant=a}"] == 7.0
    return dict(reg.counters), dict(reg.gauges)


def test_labeled_metrics_series():
    twin(PAIR, _labeled_series)


def _cardinality_cap(p):
    reg = p.obs.MetricsRegistry(max_label_sets=4)
    for i in range(10):
        reg.inc("hits", labels={"tenant": f"t{i:02d}"})
    assert len([k for k in reg.counters if k.startswith("hits{")]) == 4
    assert reg.counters["labels_dropped"] == 6.0
    reg.inc("hits", labels={"tenant": "t00"})
    assert reg.counters["hits{tenant=t00}"] == 2.0
    return dict(reg.counters)


def test_labeled_metrics_cardinality_cap():
    twin(PAIR, _cardinality_cap)


# --------------------------------------------------------------------------
# service broker
# --------------------------------------------------------------------------
def _tenant_counts(reg):
    """The tenant-labelled counters that count tasks (cpu_seconds is a
    measured time)."""
    return {k: v for k, v in reg.counters.items()
            if "{tenant=" in k and not k.startswith("cpu_seconds")}


def _end_to_end(p, tmp):
    d = tmp / p.name
    with p.service.ServiceBroker(
            {"toy": lambda: _toy(p)}, weights={"a": 1.0, "b": 2.0},
            journal_dir=str(d), journal_every_s=0.05, n_workers=2,
            registry=p.obs.MetricsRegistry()) as svc:
        reqs = [_req(p, i, tenant="a" if i % 2 else "b", task_id=f"e{i}")
                for i in range(10)]
        res = svc.run_all(reqs, timeout=30.0)
        assert all(r.status == "ok" for r in res)
        bill = svc.billing()
        assert bill.get("a", 0.0) >= 0.0 and set(bill) == {"a", "b"}
        assert svc.open_tasks() == {}
        assert svc.registry.counters["tasks_submitted{tenant=a}"] == 5.0
        assert svc.registry.counters["tasks_ok{tenant=b}"] == 5.0
        path = svc.checkpoint()
        assert path is not None and os.path.exists(path)
    loaded = p.checkpoint.Journal(d).latest()
    assert loaded is not None
    return ([(r.task_id, r.status, r.value) for r in res],
            _tenant_counts(svc.registry), loaded[1]["weights"],
            sorted(loaded[1]["snapshot"]["completed"].items()))


def test_service_end_to_end_with_billing(tmp_path):
    twin(PAIR, _end_to_end, tmp_path)


def test_service_backpressure_quota():
    """Thread-timing property, on the port: the quota refuses at once,
    a bounded blocking submit times out, other tenants pass, and a
    blocking submit admits once a slot frees."""
    svc = tservice.ServiceBroker({"toy": lambda: _slow(T, 0.3)},
                                 quotas={"a": 2}, n_workers=1)
    try:
        ids = [svc.submit(_req(T, i)) for i in range(2)]
        with pytest.raises(tservice.Backpressure) as ei:
            svc.submit(_req(T, 9), block=False)
        assert ei.value.tenant == "a"
        assert ei.value.open_tasks == 2
        assert ei.value.quota == 2
        with pytest.raises(tservice.Backpressure):
            svc.submit(_req(T, 9), timeout=0.05)
        other = svc.submit(_req(T, 0, tenant="b"), block=False)
        t0 = time.monotonic()
        svc.submit(_req(T, 3), timeout=10.0)
        assert time.monotonic() - t0 < 10.0
        for t in ids + [other]:
            assert svc.result(t, timeout=30.0).status == "ok"
    finally:
        svc.shutdown()


def _deadline_slo(p):
    with p.service.ServiceBroker({"toy": lambda: _slow(p, 0.05)},
                                 n_workers=1) as svc:
        ok = svc.submit(_req(p, 0, deadline=1e9))
        miss = svc.submit(_req(p, 1, deadline=1e-9))
        svc.result(ok, 30.0), svc.result(miss, 30.0)
        c = svc.registry.counters
        assert c["deadline_total{tenant=a}"] == 2.0
        assert c["deadline_missed{tenant=a}"] == 1.0
        return _tenant_counts(svc.registry)


def test_service_deadline_slo_accounting():
    twin(PAIR, _deadline_slo)


def _crash_reqs(p):
    return [_req(p, i, tenant="a" if i % 3 else "b", task_id=f"crash-{i}")
            for i in range(16)]


def test_service_crash_recovery_zero_lost(tmp_path):
    """The uninterrupted run through the reference; the port's service
    killed mid-workload and recovered from its journal reaches the same
    terminal set — zero lost tasks — with its weights and billing."""
    with jservice.ServiceBroker({"toy": lambda: _slow(J, 0.02)},
                                n_workers=2) as ref:
        ref_res = ref.run_all(_crash_reqs(J), timeout=60.0)
    ref_terminal = {(r.task_id, r.status) for r in ref_res}

    reqs = _crash_reqs(T)
    svc = tservice.ServiceBroker({"toy": lambda: _slow(T, 0.05)},
                                 weights={"a": 1.0, "b": 4.0},
                                 journal_dir=str(tmp_path),
                                 journal_every_s=0.02, n_workers=2)
    ids = [svc.submit(r) for r in reqs]
    while len([r for r in svc.records() if r.status == "ok"]) < 6:
        time.sleep(0.01)
    svc.checkpoint()
    svc.kill()
    done_before = {r.task_id for r in svc.records() if r.status == "ok"}
    assert 0 < len(done_before) < len(reqs)

    svc2 = tservice.ServiceBroker.recover({"toy": lambda: _slow(T, 0.05)},
                                          journal_dir=str(tmp_path),
                                          n_workers=2)
    try:
        assert svc2.weights == {"a": 1.0, "b": 4.0}
        res = [svc2.result(t, timeout=60.0) for t in ids]
        assert {(r.task_id, r.status) for r in res} == ref_terminal
        assert all(r.status == "ok" for r in res)
        assert sum(svc2.billing().values()) > 0.0
    finally:
        svc2.shutdown()


def _recover_empty(p, tmp):
    svc = p.service.ServiceBroker.recover({"toy": lambda: _toy(p)},
                                          journal_dir=str(tmp / p.name),
                                          n_workers=1)
    try:
        out = svc.result(svc.submit(_req(p, 0)), 30.0)
        assert out.status == "ok"
        return out.status, out.value
    finally:
        svc.shutdown()


def test_service_recover_empty_dir(tmp_path):
    twin(PAIR, _recover_empty, tmp_path)


def _default_tenant(p):
    with p.service.ServiceBroker({"toy": lambda: _toy(p)},
                                 n_workers=1) as svc:
        r = p.core.EvalRequest("toy", [[2.0]], time_request=1.0,
                               time_limit=10.0)
        assert r.tenant == "default"
        out = svc.result(svc.submit(r), 30.0)
        assert out.status == "ok" and out.value == [[4.0]]
        assert set(svc.billing()) == {"default"}
        return r.tenant, out.status, out.value, sorted(svc.billing())


def test_service_default_tenant_single_owner_path():
    twin(PAIR, _default_tenant)


def _gp_model(p):
    def fn(q, c):
        time.sleep(0.002 + 0.004 * float(q[0][0]) + 0.002 * float(q[0][1]))
        return [[float(q[0][0]) + float(q[0][1])]]
    return p.task.LambdaModel("toy", fn, 2, 1)


def test_port_recovers_a_reference_journal_with_the_gp(tmp_path,
                                                       monkeypatch):
    """A journal written by the reference's `ServiceBroker` with
    `predictor="gp"` (killed mid-workload) is recovered by the port's:
    every task reaches ok.  The port recovers with no workers first, so
    its predictor is read exactly as the journal left it: with the
    reference's fit carried across, its `predict` and `predict_many`
    match a reference predictor restored from the same state at 1e-4
    (relative, on seconds).  Then workers come up and drain the rest."""
    rng = np.random.default_rng(0)
    thetas = rng.uniform(0.0, 1.0, (24, 2))
    ids = [f"gp-{i}" for i in range(len(thetas))]
    svc = jservice.ServiceBroker({"toy": lambda: _gp_model(J)},
                                 weights={"a": 1.0, "b": 2.0},
                                 predictor="gp", journal_dir=str(tmp_path),
                                 journal_every_s=0.02, n_workers=2)
    for tid, th in zip(ids, thetas):
        svc.submit(J.core.EvalRequest(
            "toy", [th.tolist()], time_request=1.0, time_limit=30.0,
            tenant="a" if int(tid[3:]) % 3 else "b", task_id=tid))
    deadline = time.monotonic() + 60.0
    while svc._ex.predictor.n_fits < 1 or \
            len([r for r in svc.records() if r.status == "ok"]) < 12:
        assert time.monotonic() < deadline, "the reference never fitted"
        time.sleep(0.01)
    svc.checkpoint()
    svc.kill()
    svc._writer.join(timeout=5.0)      # its last publish is on disk
    seq, state = jcheckpoint.Journal(tmp_path).latest()
    pred_state = state["snapshot"]["predictor"]
    assert pred_state["kind"] == "gp" and len(pred_state["xs"]) >= 8

    carry_reference_fit(monkeypatch)
    svc2 = tservice.ServiceBroker.recover({"toy": lambda: _gp_model(T)},
                                          journal_dir=str(tmp_path),
                                          predictor="gp", n_workers=0)
    try:
        assert svc2.weights == {"a": 1.0, "b": 2.0}
        tpred = svc2._ex.predictor
        assert isinstance(tpred, tsched.GPRuntimePredictor)
        jpred = jsched.GPRuntimePredictor()
        jpred.load_state(pred_state)
        assert tpred._post is not None and jpred._post is not None
        assert tpred.state_dict()["xs"] == jpred.state_dict()["xs"]
        queries = rng.uniform(-0.2, 1.2, (40, 2)).tolist()
        np.testing.assert_allclose(
            [tpred.predict(r) for r in _reqs(T, queries)],
            [jpred.predict(r) for r in _reqs(J, queries)], rtol=1e-4)
        np.testing.assert_allclose(tpred.predict_many(_reqs(T, queries)),
                                   jpred.predict_many(_reqs(J, queries)),
                                   rtol=1e-4)
        svc2._ex.scale_to(2)
        res = [svc2.result(t, timeout=60.0) for t in ids]
        assert [r.task_id for r in res] == ids
        assert all(r.status == "ok" for r in res)     # zero lost
        assert sum(svc2.billing().values()) > 0.0
    finally:
        svc2.shutdown()


# --------------------------------------------------------------------------
# chaos: FaultPlan / ChaosInjector mechanics
# --------------------------------------------------------------------------
def _elastic_cfg(p):
    return p.cluster.AutoAllocConfig(
        workers_per_alloc=2, walltime_s=300.0, backlog_high_s=10.0,
        backlog_low_s=2.0, max_pending=3, max_allocations=6,
        min_allocations=1, idle_drain_s=30.0, hysteresis_s=5.0)


def _hedge_trace(p):
    trace = [p.cluster.TraceTask(t=float(i) * 0.5, runtime=2.0)
             for i in range(14)]
    trace += [p.cluster.TraceTask(t=7.0, runtime=120.0),
              p.cluster.TraceTask(t=7.5, runtime=90.0)]
    return trace


def _plan_sorted(p):
    ev = p.chaos.FaultEvent
    plan = p.chaos.FaultPlan(events=(
        ev(t=20.0, kind="preempt", duration_s=30.0),
        ev(t=5.0, kind="worker_crash", target=3),
        ev(t=5.0, kind="worker_crash", target=1)))
    assert [e.t for e in plan.events] == [5.0, 5.0, 20.0]
    assert [e.target for e in plan.events[:2]] == [1, 3]
    assert len(plan) == 3
    assert plan.kinds() == {"worker_crash": 2, "preempt": 1}
    with pytest.raises(ValueError):
        ev(t=0.0, kind="meteor_strike")
    return plan, plan.to_dicts()


def test_fault_plan_sorted_and_validated():
    twin(PAIR, _plan_sorted)


def _plan_roundtrip(p):
    rates = {"worker_crash": 1 / 100.0, "preempt": 1 / 200.0}
    a = p.chaos.FaultPlan.generate(seed=11, horizon_s=500.0, rates=rates)
    b = p.chaos.FaultPlan.generate(seed=11, horizon_s=500.0, rates=rates)
    c = p.chaos.FaultPlan.generate(seed=12, horizon_s=500.0, rates=rates)
    assert a.events == b.events
    assert a.events != c.events
    assert len(a) > 0
    assert p.chaos.FaultPlan.from_dicts(a.to_dicts()).events == a.events
    return a.to_dicts(), c.to_dicts()


def test_fault_plan_roundtrip_and_seeded_generation():
    dicts, _ = twin(PAIR, _plan_roundtrip)
    # a plan written by either package loads in the other
    assert jchaos.FaultPlan.from_dicts(dicts).to_dicts() == dicts


def _injector(p):
    ev = p.chaos.FaultEvent
    inj = p.chaos.ChaosInjector(p.chaos.FaultPlan(events=(
        ev(t=1.0, kind="worker_crash"), ev(t=2.0, kind="corrupt_result"),
        ev(t=9.0, kind="worker_crash"))))
    seen = []
    inj.on("worker_crash", lambda e, now: seen.append((e.t, now)))
    obs = [inj.next_time(), inj.fire(5.0)]
    assert obs == [1.0, 2]
    assert seen == [(1.0, 5.0)]
    assert inj.take_corruption() is True
    assert inj.take_corruption() is False
    assert inj.next_time() == 9.0
    inj.set_slow(wid=2, factor=3.0, until=20.0)
    slow = [inj.slow_factor(2, 10.0), inj.slow_factor(2, 25.0),
            inj.slow_factor(7, 10.0)]
    assert slow == [3.0, 1.0, 1.0]
    return obs, seen, slow


def test_injector_fires_in_order_and_tracks_state():
    twin(PAIR, _injector)


class _FakeExecutor:
    workers = ()
    tracer = None
    _broker = None
    _stepper = None


def _attach_journal_torn(p, tmp):
    journal = p.checkpoint.Journal(tmp / p.name / "j")
    ex = _FakeExecutor()
    inj = p.chaos.attach_chaos(
        ex, p.chaos.FaultPlan(events=(
            p.chaos.FaultEvent(t=3.0, kind="journal_torn"),)),
        journal=journal)
    assert ex._chaos is inj
    assert journal.torn_next is False
    inj.fire(5.0)
    assert journal.torn_next is True
    return journal.torn_next


def test_attach_chaos_arms_journal_torn_writes(tmp_path):
    twin(PAIR, _attach_journal_torn, tmp_path)


# --------------------------------------------------------------------------
# chaos: faulted differential parity
# --------------------------------------------------------------------------
def _faulted_parity(p):
    ev = p.chaos.FaultEvent
    plan = p.chaos.FaultPlan(events=(
        ev(t=12.0, kind="worker_crash", target=1),
        ev(t=20.0, kind="preempt", target=0, duration_s=15.0),
        ev(t=31.0, kind="corrupt_result", target=0)))
    retry = p.task.RetryPolicy(base_s=1.0, factor=2.0, max_s=20.0,
                               jitter=0.3, quarantine_after=3)
    ts, tl = p.obs.Tracer(), p.obs.Tracer()
    rep = p.cluster.run_parity(
        p.core.backends.get("hq"), _hedge_trace(p),
        autoalloc=_elastic_cfg(p), max_workers=12, seed=5, max_attempts=6,
        fault_plan=plan, retry_policy=retry, straggler_factor=4.0,
        straggler_min_completed=5, tracers=(ts, tl))
    assert rep.ok, rep.divergences[:5]
    assert Counter(r.status for r in rep.sim.records) == {"ok": 16}
    counts = Counter(e[2] for e in ts.events())
    assert counts["chaos.fire"] == 3
    for name in ("task.requeue", "task.migrate", "task.speculate",
                 "task.hedge_cancel"):
        assert counts[name] >= 1, name
    assert p.obs.span_sequence(ts) == p.obs.span_sequence(tl)
    checker = p.chaos.InvariantChecker()
    expected = [f"trace-{i}" for i in range(16)]
    for res, tr in ((rep.sim, ts), (rep.live, tl)):
        inv = checker.check(records=res.records,
                            allocations=res.allocations,
                            events=tr.events(), expected_tasks=expected)
        assert inv.ok, inv.violations[:5]
    return (rep.sim.records, rep.live.records, rep.sim.allocations,
            p.obs.span_sequence(ts), dict(counts))


def test_faulted_parity_exact_with_all_recovery_paths():
    twin(PAIR, _faulted_parity)


def _crash_plan(p, n):
    return p.chaos.FaultPlan(events=tuple(
        p.chaos.FaultEvent(t=10.0 + 20.0 * i, kind="worker_crash", target=0)
        for i in range(n)))


def _backoff_pinned(p):
    retry = p.task.RetryPolicy(base_s=1.0, factor=2.0, jitter=0.2,
                               quarantine_after=3)
    ts, tl = p.obs.Tracer(), p.obs.Tracer()
    rep = p.cluster.run_parity(
        p.core.backends.get("hq"), [p.cluster.TraceTask(t=0.0, runtime=500.0)],
        n_workers=1, seed=2, max_attempts=10, fault_plan=_crash_plan(p, 4),
        retry_policy=retry, tracers=(ts, tl))
    assert rep.ok, rep.divergences[:5]
    assert [r.status for r in rep.sim.records] == ["quarantined"]
    assert [r.status for r in rep.live.records] == ["quarantined"]

    def releases(tr):
        return [(e[6]["attempt"], e[6]["since"], e[6]["release"])
                for e in tr.events() if e[2] == "task.requeue"]

    expect = [(1, 0.0, 10.823104785525953),
              (2, 10.823104785525953, 32.146764199914315)]
    assert releases(ts) == expect
    assert releases(tl) == expect
    quarantined = [e for e in ts.events() if e[2] == "task.quarantined"]
    assert len(quarantined) == 1
    assert quarantined[0][6]["attempt"] == 3
    assert quarantined[0][6]["since"] == 32.146764199914315
    return releases(ts), releases(tl), quarantined[0][6]


def test_backoff_jitter_requeue_timestamps_pinned():
    twin(PAIR, _backoff_pinned)


def _retry_backoff(p):
    r = p.task.RetryPolicy(base_s=2.0, factor=2.0, max_s=30.0, jitter=0.5)
    a = r.backoff_s("task-x", 3, seed=7)
    assert a == r.backoff_s("task-x", 3, seed=7)
    assert a != r.backoff_s("task-x", 3, seed=8)
    assert a != r.backoff_s("task-y", 3, seed=7)
    base = min(2.0 * 2.0 ** (3 - 1), 30.0)
    assert base * 0.5 <= a <= base * 1.5
    nojit = p.task.RetryPolicy(base_s=2.0, factor=2.0, max_s=30.0,
                               jitter=0.0)
    assert nojit.backoff_s("t", 10, seed=0) == 30.0
    return [r.backoff_s(f"task-{k}", n, seed=s)
            for k in "xyz" for n in (1, 3, 6) for s in (0, 7)]


def test_retry_policy_backoff_deterministic_and_bounded():
    twin(PAIR, _retry_backoff)


def _crash_run(p, n_crashes, quarantine_after):
    rep = p.cluster.run_parity(
        p.core.backends.get("hq"), [p.cluster.TraceTask(t=0.0, runtime=500.0)],
        n_workers=1, seed=2, max_attempts=10,
        fault_plan=_crash_plan(p, n_crashes),
        retry_policy=p.task.RetryPolicy(base_s=1.0, factor=2.0, jitter=0.2,
                                        quarantine_after=quarantine_after),
        walltime_s=3600.0)
    assert rep.ok, rep.divergences[:3]
    assert rep.sim.records[0].status == rep.live.records[0].status
    return rep.sim.records[0]


def _quarantine_cells(p):
    out = {}
    for threshold in (1, 2, 3):
        for crashes in range(5):
            rec = _crash_run(p, crashes, threshold)
            want = "quarantined" if crashes >= threshold else "ok"
            assert rec.status == want, (crashes, threshold)
            out[f"{crashes}/{threshold}"] = rec
    return out


def test_quarantine_fires_iff_threshold_crossed():
    twin(PAIR, _quarantine_cells)


@given(st.integers(min_value=1, max_value=4),
       st.integers(min_value=0, max_value=6))
@settings(max_examples=12, deadline=None)
def test_quarantine_threshold_property(threshold, crashes):
    rec = twin(PAIR, _crash_run, crashes, threshold)
    assert rec.status == ("quarantined" if crashes >= threshold else "ok")


# --------------------------------------------------------------------------
# chaos: torn journal writes, directory fsync
# --------------------------------------------------------------------------
def _torn_writes(p, tmp):
    d = tmp / p.name / "j"
    j = p.checkpoint.Journal(d, keep=10)
    for i in range(6):
        j.write({"round": i})
        j.torn_next = True
        j.write({"round": f"torn-{i}"})
        assert j.torn_next is False
        seq, state = j.latest()
        assert state == {"round": i}
    j2 = p.checkpoint.Journal(d, keep=10)
    _, state = j2.latest()
    assert state == {"round": 5}
    j2.write({"round": 99})
    assert j2.latest()[1] == {"round": 99}
    return _files(d)


def test_journal_survives_torn_writes(tmp_path):
    """Byte-equal directories, torn files included."""
    twin(PAIR, _torn_writes, tmp_path)


def _dir_fsync(p, tmp):
    j = p.checkpoint.Journal(tmp / p.name / "j")
    path = j.write({"a": 1})
    assert path.exists()
    j._fsync_dir()
    assert j.latest()[1] == {"a": 1}
    return path.name, j.latest()


def test_journal_dir_fsync_is_tolerant(tmp_path):
    twin(PAIR, _dir_fsync, tmp_path)


# --------------------------------------------------------------------------
# chaos: InvariantChecker
# --------------------------------------------------------------------------
def _traced_hedge_run(p):
    tracer = p.obs.Tracer()
    res = p.cluster.simulate_cluster(
        p.core.backends.get("hq"), _hedge_trace(p),
        autoalloc=_elastic_cfg(p), max_workers=12, seed=5, max_attempts=6,
        tracer=tracer)
    return res, tracer


def _invariants_clean(p):
    res, tracer = _traced_hedge_run(p)
    inv = p.chaos.InvariantChecker().check(
        records=res.records, allocations=res.allocations,
        events=tracer.events(),
        expected_tasks=[f"trace-{i}" for i in range(16)])
    assert inv.ok, inv.violations[:5]
    assert inv.measures["n_records"] == 16.0
    assert inv.measures["n_lost"] == 0.0
    assert inv.measures["billed_busy_s"] == inv.measures["accounted_busy_s"]
    return inv


def test_invariant_checker_clean_run_passes():
    twin(PAIR, _invariants_clean)


def _invariants_flag(p):
    res, tracer = _traced_hedge_run(p)
    checker = p.chaos.InvariantChecker()
    dup = checker.check(records=list(res.records) + [res.records[0]],
                        allocations=res.allocations, events=tracer.events())
    assert not dup.ok
    missing = checker.check(records=res.records[:-1],
                            allocations=res.allocations,
                            events=tracer.events(),
                            expected_tasks=[f"trace-{i}" for i in range(16)])
    assert not missing.ok
    with pytest.raises(AssertionError):
        missing.assert_ok()
    return dup.violations, missing.violations


def test_invariant_checker_flags_violations():
    twin(PAIR, _invariants_flag)


def _quarantine_attribution(p):
    tracer = p.obs.Tracer()
    rep = p.cluster.run_parity(
        p.core.backends.get("hq"), [p.cluster.TraceTask(t=0.0, runtime=500.0)],
        n_workers=1, seed=2, max_attempts=10,
        tracers=(tracer, p.obs.Tracer()), fault_plan=_crash_plan(p, 4),
        retry_policy=p.task.RetryPolicy(base_s=1.0, factor=2.0, jitter=0.2,
                                        quarantine_after=3))
    assert rep.ok, rep.divergences[:3]
    bd = rep.sim.overhead_attribution["per_task"]["trace-0"]
    assert bd.status == "quarantined"
    assert bd.quarantine_s > 0
    assert bd.retry_s > 0
    assert bd.speculation_s == 0.0
    assert abs(bd.overhead_s - rep.sim.records[0].overhead) < 1e-6
    return bd, rep.sim.overhead_attribution["totals"]


def test_quarantine_attribution_additive():
    twin(PAIR, _quarantine_attribution)


# --------------------------------------------------------------------------
# chaos: offload degradation
# --------------------------------------------------------------------------
def _degradation_cycle(p):
    tracer = p.obs.Tracer()
    sur = p.sched.SurrogateOffload(drift_disable_s=120.0)
    sur.tracer = tracer
    assert sur.degraded_until is None
    sur.set_degraded(10.0, 40.0, reason="outage")
    assert sur.degraded_until == 40.0
    sur.set_degraded(12.0, 50.0, reason="outage")
    sur.tick_degraded(30.0)
    assert sur.degraded_until == 50.0
    sur.tick_degraded(50.0)
    assert sur.degraded_until is None
    edges = [e[6] for e in tracer.events() if e[2] == "offload.degraded"]
    assert edges == [{"degraded": True, "reason": "outage"},
                     {"degraded": False, "reason": "outage"}]
    return tracer.events()


def test_offload_degradation_cycle_and_instants():
    twin(PAIR, _degradation_cycle)


def _drift_alarm(p):
    sur = p.sched.SurrogateOffload(drift_disable_s=100.0)
    mon = p.obs.CalibrationMonitor(p.core.backends.get("hq"), min_n=4,
                                   on_alarm=sur.note_drift_alarm)
    for i in range(6):
        mon.observe("init", 1.0, 4.0, float(i))
    assert mon.alarms, "drift alarm did not fire"
    assert sur.degraded_until is not None
    assert sur.degraded_reason == "drift:init"
    until = sur.degraded_until
    assert until == mon.alarms[0]["t"] + 100.0
    sur.tick_degraded(sur.degraded_until)
    assert sur.degraded_until is None
    return mon.alarms, until


def test_calib_drift_alarm_degrades_offload():
    twin(PAIR, _drift_alarm)


class _FakeSurrogate:
    latency_s = 0.05
    n_virtual_workers = 1
    tracer = None
    degraded_until = None

    def __init__(self):
        self.calls = []

    def decide(self, req, cost=None):
        return False

    def note_served(self):
        pass

    def observe(self, *a, **kw):
        pass

    def set_degraded(self, now, until, reason="outage"):
        self.calls.append(("set", now, until, reason))
        self.degraded_until = until

    def tick_degraded(self, now):
        if self.degraded_until is not None and now >= self.degraded_until:
            self.calls.append(("rearm", now))
            self.degraded_until = None


def _surrogate_outage(p):
    sur = _FakeSurrogate()
    broker = p.cluster.Broker()
    broker.attach_surrogate(sur)
    res = p.cluster.simulate_cluster(
        p.core.backends.get("hq"), _hedge_trace(p), broker=broker,
        autoalloc=_elastic_cfg(p), max_workers=12, seed=5, max_attempts=6,
        fault_plan=p.chaos.FaultPlan(events=(p.chaos.FaultEvent(
            t=15.0, kind="surrogate_outage", duration_s=40.0),)))
    assert Counter(r.status for r in res.records)["ok"] == 16
    sets = [c for c in sur.calls if c[0] == "set"]
    rearms = [c for c in sur.calls if c[0] == "rearm"]
    assert sets == [("set", 15.0, 55.0, "outage")]
    assert len(rearms) == 1 and rearms[0][1] >= 55.0
    return sur.calls, res.records


def test_surrogate_outage_fault_degrades_and_rearms():
    twin(PAIR, _surrogate_outage)


# --------------------------------------------------------------------------
# fair share: FairSharePolicy
# --------------------------------------------------------------------------
def _freq(p, tenant, i, cost=10.0):
    return p.core.EvalRequest("m", [float(i)], time_request=cost,
                              time_limit=100.0, task_id=f"{tenant}-{i}",
                              tenant=tenant)


def _registered(p):
    pol = p.sched.make_policy("fairshare", None)
    assert isinstance(pol, p.sched.FairSharePolicy)
    assert pol.name == "fairshare"
    return type(pol).__name__, pol.name


def test_registered_and_constructible():
    twin(PAIR, _registered)


def _passthrough(p):
    pol = p.sched.FairSharePolicy(policy="fcfs")
    reqs = [_freq(p, "solo", i) for i in range(20)]
    for r in reqs:
        pol.push(r, 0)
    popped = [pol.pop(None)[0].task_id for _ in range(20)]
    assert popped == [r.task_id for r in reqs]
    assert pol.pop(None) is None
    return popped


def test_single_tenant_is_inner_policy_passthrough():
    twin(PAIR, _passthrough)


def _default_untagged(p):
    pol = p.sched.FairSharePolicy()
    r = p.core.EvalRequest("m", [0.0], time_request=1.0, time_limit=10.0)
    pol.push(r, 0)
    assert pol.tenant_pending_all() == {"default": 1}
    assert pol.pop(None)[0] is r
    return {"default": 1}


def test_default_tenant_untagged_requests():
    twin(PAIR, _default_untagged)


def _weighted_shares(p):
    weights = {"a": 1.0, "b": 2.0, "c": 4.0}
    pol = p.sched.FairSharePolicy(policy="fcfs", weights=weights,
                                  quantum_s=10.0)
    n_per = 70
    for i in range(n_per):
        for t in weights:
            pol.push(_freq(p, t, i), 0)
    order = []
    for _ in range((3 * n_per) // 2):
        item = pol.pop(None)
        assert item is not None
        order.append(item[0].task_id)
    served = pol.served_cost()
    total = sum(served.values())
    wsum = sum(weights.values())
    for t, w in weights.items():
        share, target = served[t] / total, w / wsum
        assert abs(share - target) / target <= 0.10, (t, share, target)
    return order, served


def test_weighted_shares_converge():
    twin(PAIR, _weighted_shares)


def _no_starvation(p):
    pol = p.sched.FairSharePolicy(
        weights={"victim": 1.0, "adv1": 8.0, "adv2": 8.0}, quantum_s=10.0)
    for i in range(4):
        pol.push(_freq(p, "victim", i), 0)
    k = between = served = worst = 0
    order = []
    for _ in range(600):
        pol.push(_freq(p, "adv1", 1000 + k), 0)
        pol.push(_freq(p, "adv2", 2000 + k), 0)
        k += 1
        item = pol.pop(None)
        assert item is not None
        order.append(item[0].task_id)
        if item[0].tenant == "victim":
            served += 1
            worst = max(worst, between)
            between = 0
            if served == 4:
                break
        else:
            between += 1
    assert served == 4, "victim starved behind weight-8 tenants"
    assert worst <= 40
    return order, worst


def test_no_starvation_under_adversarial_bursts():
    twin(PAIR, _no_starvation)


def _unknown_tenant(p):
    pol = p.sched.FairSharePolicy(weights={"a": 4.0})
    pol.push(_freq(p, "a", 0), 0)
    pol.push(_freq(p, "mystery", 0), 0)
    got = [pol.pop(None)[0].tenant for _ in range(2)]
    assert set(got) == {"a", "mystery"}
    return got


def test_unknown_tenant_gets_default_weight():
    twin(PAIR, _unknown_tenant)


def _introspection(p):
    pol = p.sched.FairSharePolicy()
    for i in range(3):
        pol.push(_freq(p, "a", i, cost=5.0), 0)
    pol.push(_freq(p, "b", 0, cost=7.0), 0)
    assert pol.tenant_pending_all() == {"a": 3, "b": 1}
    bc = pol.tenant_backlog_cost()
    assert bc["a"] == pytest.approx(15.0)
    assert bc["b"] == pytest.approx(7.0)
    assert len(pol) == 4
    ids = sorted(r.task_id for r, _ in pol.pending())
    assert ids == ["a-0", "a-1", "a-2", "b-0"]
    return pol.tenant_pending_all(), bc, ids


def test_backlog_cost_and_pending_introspection():
    twin(PAIR, _introspection)


def _quota_headroom(p):
    pol = p.sched.FairSharePolicy(quotas={"a": 2})
    out = [pol.quota_headroom("a")]
    pol.push(_freq(p, "a", 0), 0)
    out += [pol.quota_headroom("a"), pol.quota_headroom("unlimited")]
    assert out == [2, 1, None]
    return out


def test_quota_headroom_advisory():
    twin(PAIR, _quota_headroom)


def _conservation(p, pushes, wa, wb):
    pol = p.sched.FairSharePolicy(weights={"a": float(wa), "b": float(wb)},
                                  quantum_s=2.0)
    pushed = []
    for j, (tenant, cost) in enumerate(pushes):
        r = _freq(p, tenant, j, cost=float(cost))
        pushed.append(r.task_id)
        pol.push(r, 0)
    popped = []
    while len(pol):
        item = pol.pop(None)
        assert item is not None, "pop returned None on non-empty queue"
        popped.append(item[0].task_id)
    assert sorted(popped) == sorted(pushed)
    assert pol.pop(None) is None
    assert pol.tenant_pending_all() == {}
    return popped


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["a", "b", "c", "d"]),
                          st.integers(min_value=1, max_value=8)),
                min_size=1, max_size=60),
       st.integers(min_value=1, max_value=8),
       st.integers(min_value=1, max_value=8))
def test_property_conservation(pushes, wa, wb):
    """Every pushed item pops exactly once, in the same order on both."""
    twin(PAIR, _conservation, pushes, wa, wb)


# --------------------------------------------------------------------------
# fair share: sim / live
# --------------------------------------------------------------------------
WEIGHTS = {"a": 1.0, "b": 2.0, "c": 4.0}     # benchmarks/broker_service.py


def _parity_fairshare(p):
    trace = p.cluster.with_tenants(p.cluster.bimodal_trace(n=24, seed=11),
                                   WEIGHTS)
    rep = p.cluster.run_parity(
        p.core.backends.get("hq"), trace,
        policy=lambda: p.sched.FairSharePolicy(policy="fcfs",
                                               weights=WEIGHTS,
                                               quantum_s=20.0),
        n_workers=3, seed=7)
    assert rep.ok, "sim/live diverged:\n" + "\n".join(rep.divergences)
    assert len(rep.sim.records) == 24
    return rep.sim.records, rep.live.records


def test_parity_fairshare_multitenant():
    twin(PAIR, _parity_fairshare)


def _fair_shares(p, burst):
    """The fair-share recipe of benchmarks/broker_service.py (and
    tests/test_fairshare.py::test_sim_cpu_second_shares at 112): tenant
    CPU-second shares at the 3/4-drain horizon."""
    trace = p.cluster.with_tenants(
        p.cluster.bursty_trace(n_bursts=1, burst_size=burst,
                               burst_span_s=1.0, runtime_s=4.0, jitter=0.0,
                               seed=3), WEIGHTS)
    tenant_of = {f"trace-{i}": tt.tenant for i, tt in enumerate(trace)}
    res = p.cluster.simulate_cluster(
        p.core.backends.get("hq"), trace,
        policy=lambda: p.sched.FairSharePolicy(weights=WEIGHTS,
                                               quantum_s=8.0),
        n_workers=2, seed=3)
    done = sorted((r for r in res.records if r.status == "ok"),
                  key=lambda r: r.end_t)
    part = done[:(3 * len(done)) // 4]
    cpu = {t: 0.0 for t in WEIGHTS}
    for r in part:
        cpu[tenant_of[r.task_id]] += r.cpu_time
    total = sum(cpu.values())
    wsum = sum(WEIGHTS.values())
    shares = {t: cpu[t] / total for t in WEIGHTS}
    err = {t: abs(shares[t] - w / wsum) / (w / wsum)
           for t, w in WEIGHTS.items()}
    return shares, err, res.records


def _sim_shares(p):
    shares, err, records = _fair_shares(p, 112)
    for t in WEIGHTS:
        assert err[t] <= 0.10, f"tenant {t}: cpu share {shares[t]:.3f}"
    return shares, records


def test_sim_cpu_second_shares():
    twin(PAIR, _sim_shares)


@pytest.mark.parametrize("burst", [56, 112])
def test_fair_share_recipe_equal_shares(burst):
    """benchmarks/broker_service.py's fair-share measure, at its quick
    (56) and full (112) burst: the simulation is deterministic, so the
    two packages give the same shares exactly, within its 10% gate."""
    shares, err, _ = twin(PAIR, _fair_shares, burst)
    assert max(err.values()) <= 0.10, shares
