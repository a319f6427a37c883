"""The port's cluster simulation, chaos and observability stack against
`repro`.

`simulate_cluster`, the chaos plan and injector, the invariants, the
metrics registry, calibration, replay and the parity harness are host
code on numpy's seeded generator in both packages: given the same trace
and configuration, the port's records, allocation records, autoalloc
decisions, stepper events, registry samples and overhead attribution
equal the reference's exactly.  Where the GP runs (the runtime predictor
and the surrogate offload), the two sides work from the same posterior
and are held at the tolerances stated beside their asserts.
"""
import types

import numpy as np
import pytest
import torch

import repro.chaos as jchaos
import repro.cluster as jcluster
import repro.obs as jobs
import repro.sched as jsched
import repro_torch.chaos as tchaos
import repro_torch.cluster as tcluster
import repro_torch.obs as tobs
import repro_torch.sched as tsched
from repro.core import backends as jbackends
from repro.core import task as jtask
from repro.uq import gp as jgp
from repro_torch import device
from repro_torch.core import backends as tbackends
from repro_torch.core import task as ttask
from repro_torch.sched.offload import record_decisions
from repro_torch.uq import gp as tgp
from torch_port_util import (assert_records_equal,  # noqa: F401
                             carry_reference_fit, export_posterior, on_cpu,
                             plain)

pytestmark = pytest.mark.usefixtures("on_cpu")

J = types.SimpleNamespace(cluster=jcluster, chaos=jchaos, obs=jobs,
                          sched=jsched, backends=jbackends, task=jtask)
T = types.SimpleNamespace(cluster=tcluster, chaos=tchaos, obs=tobs,
                          sched=tsched, backends=tbackends, task=ttask)

ELASTIC = dict(workers_per_alloc=2, walltime_s=300.0, backlog_high_s=30.0,
               backlog_low_s=5.0, max_pending=2, max_allocations=4,
               min_allocations=0, idle_drain_s=20.0, hysteresis_s=5.0)
KILL = dict(workers_per_alloc=2, backlog_high_s=30, backlog_low_s=5,
            max_pending=2, max_allocations=4, min_allocations=0,
            idle_drain_s=20, hysteresis_s=5, walltime_s=25)
FAULT_RATES = {"worker_crash": 0.03, "preempt": 0.01, "slow_node": 0.01,
               "corrupt_result": 0.01}


def _scenario(p, name, seed):
    """(trace, simulate_cluster kwargs, observers) of one scenario, built
    from package `p`'s own classes."""
    c = p.cluster
    obs = {}
    if name == "bursty_static":
        return c.bursty_trace(3, 12, seed=seed), dict(n_workers=3), obs
    if name == "bimodal_elastic":
        return c.bimodal_trace(n=40, seed=seed), dict(
            autoalloc=c.AutoAllocConfig(**ELASTIC), policy="sjf",
            predictor="quantile", max_workers=8), obs
    if name == "tenants_fairshare":
        trace = c.with_tenants(c.bimodal_trace(n=36, seed=seed),
                               {"a": 1.0, "b": 2.0})
        return trace, dict(policy="fairshare", n_workers=3), obs
    if name == "walltime_kills":
        return c.bursty_trace(2, 10, seed=seed), dict(
            autoalloc=c.AutoAllocConfig(**KILL), max_attempts=2), obs
    if name == "faults":
        plan = p.chaos.FaultPlan.generate(seed, horizon_s=400.0,
                                          rates=FAULT_RATES)
        return c.bimodal_trace(n=40, seed=seed), dict(
            autoalloc=c.AutoAllocConfig(**ELASTIC), max_workers=8,
            fault_plan=plan, max_attempts=4,
            retry_policy=p.task.RetryPolicy(base_s=2.0, jitter=0.2,
                                            quarantine_after=2),
            straggler_factor=3.0), obs
    if name == "observed":
        spec = p.backends.get("hq")
        obs["tracer"] = p.obs.Tracer()
        obs["registry"] = p.obs.MetricsRegistry()
        obs["calibration"] = p.obs.CalibrationMonitor(
            spec, registry=obs["registry"], min_n=4)
        return c.bursty_trace(2, 10, seed=seed), dict(
            autoalloc=c.AutoAllocConfig(**KILL), max_attempts=6, **obs), obs
    raise KeyError(name)


def _run(p, name, seed):
    trace, kw, obs = _scenario(p, name, seed)
    res = p.cluster.simulate_cluster(p.backends.get("hq"), trace, seed=seed,
                                     **kw)
    return res, obs


def _assert_results_equal(j, t, attribution=True):
    assert_records_equal(j.records, t.records)
    assert_records_equal(j.allocations, t.allocations)
    assert plain(j.decisions) == plain(t.decisions)
    assert plain(j.events) == plain(t.events)
    if attribution:                  # present only on traced runs
        assert plain(j.overhead_attribution) == \
            plain(t.overhead_attribution)
    assert plain(j.summary()) == plain(t.summary())


SCENARIOS = ["bursty_static", "bimodal_elastic", "tenants_fairshare",
             "walltime_kills", "faults", "observed"]


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("seed", [0, 3])
def test_simulate_cluster_matches_reference(name, seed):
    (j, jo), (t, to) = _run(J, name, seed), _run(T, name, seed)
    _assert_results_equal(j, t)
    if name == "faults":
        assert any(r.status != "ok" or r.attempts > 1 for r in t.records)
    if name == "observed":
        assert j.overhead_attribution is not None
        assert jobs.span_sequence(jo["tracer"]) == \
            tobs.span_sequence(to["tracer"])
        assert plain(jo["registry"].snapshot()) == \
            plain(to["registry"].snapshot())
        assert plain(jo["registry"].timeseries()) == \
            plain(to["registry"].timeseries())
        assert to["registry"].n_samples > 0
        assert plain(jo["calibration"].summary()) == \
            plain(to["calibration"].summary())
        assert tobs.validate_chrome_trace(to["tracer"].to_chrome()) == []


@pytest.mark.parametrize("seed,n,workers_per_alloc,walltime",
                         [(0, 5, 1, 60.0), (11, 17, 2, 137.5),
                          (4097, 25, 4, 600.0), (65536, 9, 3, 75.0)])
def test_stepper_deterministic_under_seed(seed, n, workers_per_alloc,
                                          walltime):
    """Twin of tests/test_parity.py::test_stepper_deterministic_under_seed
    over fixed draws.  A record that never started carries start_t = NaN,
    which the reference's `==` on records calls unequal to itself; here
    NaN compares equal to NaN (`assert_records_equal`)."""
    spec = tbackends.get("hq")
    trace = tcluster.bimodal_trace(n=n, seed=seed)
    cfg = dict(ELASTIC, workers_per_alloc=workers_per_alloc,
               walltime_s=walltime)
    kw = dict(max_workers=8, seed=seed, max_attempts=6)
    a = tcluster.simulate_cluster(spec, trace,
                                  autoalloc=tcluster.AutoAllocConfig(**cfg),
                                  **kw)
    b = tcluster.simulate_cluster(spec, trace,
                                  autoalloc=tcluster.AutoAllocConfig(**cfg),
                                  **kw)
    _assert_results_equal(a, b)
    assert all(x[0] <= y[0] for x, y in zip(a.events, a.events[1:]))
    assert all(np.isfinite(e[0]) for e in a.events)
    ref = jcluster.simulate_cluster(
        jbackends.get("hq"), jcluster.bimodal_trace(n=n, seed=seed),
        autoalloc=jcluster.AutoAllocConfig(**cfg), **kw)
    _assert_results_equal(ref, a)


@pytest.mark.parametrize("seed", [1, 5])
def test_fault_plans_and_invariants_match_reference(seed):
    jplan = jchaos.FaultPlan.generate(seed, horizon_s=300.0,
                                      rates=dict(FAULT_RATES,
                                                 surrogate_outage=0.003))
    tplan = tchaos.FaultPlan.generate(seed, horizon_s=300.0,
                                      rates=dict(FAULT_RATES,
                                                 surrogate_outage=0.003))
    assert plain(jplan) == plain(tplan)
    assert jplan.kinds() == tplan.kinds() and len(tplan) > 0
    assert plain(tchaos.FaultPlan.from_dicts(jplan.to_dicts())) == \
        plain(tplan)
    reports = []
    for p in (J, T):
        trace, kw, obs = _scenario(p, "faults", seed)
        tracer = p.obs.Tracer()
        res = p.cluster.simulate_cluster(p.backends.get("hq"), trace,
                                         seed=seed, tracer=tracer, **kw)
        reports.append(p.chaos.InvariantChecker().check(
            records=res.records, allocations=res.allocations,
            events=tracer.events(),
            expected_tasks=[f"trace-{i}" for i in range(len(trace))]))
    assert plain(reports[0]) == plain(reports[1])
    assert reports[1].ok, reports[1].violations


# --------------------------------------------------------------------------
# calibration and sacct ingestion
# --------------------------------------------------------------------------
SACCT_LINES = [   # the rows of tests/test_calib.py
    "JobID|JobName|State|Submit|Start|End|Elapsed|Timelimit|NNodes",
    "100|gs2|COMPLETED|2024-03-05T10:00:00|2024-03-05T10:05:00"
    "|2024-03-05T10:25:00|00:20:00|01:00:00|4",
    "100.batch|batch|COMPLETED|2024-03-05T10:05:00|2024-03-05T10:05:00"
    "|2024-03-05T10:25:00|00:20:00||4",
    "101|gs2|TIMEOUT|2024-03-05T10:00:30|2024-03-05T10:10:00"
    "|2024-03-05T11:10:00|01:00:00|01:00:00|4",
    "102|gpsurrogate|COMPLETED|2024-03-05T10:01:00|2024-03-05T10:02:00"
    "|2024-03-05T10:02:05|00:00:05|00:10:00|1",
    "103|gs2|CANCELLED by 1000|2024-03-05T10:02:00|Unknown|Unknown"
    "|00:00:00|01:00:00|4",
    "104|gs2|FAILED|2024-03-05T10:02:00|2024-03-05T10:04:00"
    "|2024-03-05T10:05:00|00:01:00|01:00:00|4",
    "105|gs2|RUNNING|2024-03-05T10:03:00|2024-03-05T10:06:00|Unknown"
    "|00:30:00|01:00:00|4",
]


def test_read_sacct_and_calibrate_match_reference(tmp_path):
    jev, tev = jobs.read_sacct(SACCT_LINES), tobs.read_sacct(SACCT_LINES)
    assert plain(jev) == plain(tev) and tev
    assert plain(jobs.extract_phase_samples(jev)) == \
        plain(tobs.extract_phase_samples(tev))
    jcal = jobs.calibrate(jev, jbackends.get("slurm"), min_samples=1)
    tcal = tobs.calibrate(tev, tbackends.get("slurm"), min_samples=1)
    assert plain(jcal) == plain(tcal)
    assert jcal.describe_fits() == tcal.describe_fits()
    # the port's JSONL export reads back in the reference's schema
    path = str(tmp_path / "sacct.jsonl")
    assert tobs.sacct_to_jsonl(SACCT_LINES, path) == len(tev)
    assert plain(jobs.read_jsonl(path)) == plain(tev)
    for s in ("1-02:03:04.5", "00:20:00", "UNLIMITED", "garbage"):
        assert jobs.parse_slurm_duration(s) == tobs.parse_slurm_duration(s)


@pytest.mark.parametrize("priors", [None, {"jax-kernel": 0.42}])
def test_calibrate_traced_run_matches_reference(priors):
    """Fit from a traced sim run, then simulate with the fitted spec."""
    out = []
    for p in (J, T):
        tracer = p.obs.Tracer()
        spec = p.backends.get("hq")
        p.cluster.simulate_cluster(spec, p.cluster.bursty_trace(2, 10,
                                                                seed=1),
                                   seed=1, n_workers=3, tracer=tracer)
        cal = p.obs.calibrate(tracer.events(), spec, priors=priors)
        again = p.cluster.simulate_cluster(
            cal, p.cluster.bursty_trace(1, 6, seed=2), n_workers=2, seed=2)
        out.append((cal, again))
    assert plain(out[0][0]) == plain(out[1][0])
    assert out[0][0].describe_fits() == out[1][0].describe_fits()
    _assert_results_equal(out[0][1], out[1][1])
    assert tobs.hlo_runtime_prior({"flops": 2e12, "bytes": 1e9}) == \
        jobs.hlo_runtime_prior({"flops": 2e12, "bytes": 1e9})


# --------------------------------------------------------------------------
# replay
# --------------------------------------------------------------------------
@pytest.mark.parametrize("max_attempts", [2, 6])
def test_port_replay_roundtrip_is_exact(max_attempts):
    """Twin of test_roundtrip_identity: a sim-recorded trace replays to
    the same records and allocations, under another seed."""
    spec = tbackends.get("hq")
    cfg = tcluster.AutoAllocConfig(**KILL)
    tracer = tobs.Tracer()
    orig = tcluster.simulate_cluster(spec, tcluster.bursty_trace(2, 10,
                                                                 seed=3),
                                     autoalloc=cfg, seed=3,
                                     max_attempts=max_attempts,
                                     tracer=tracer)
    replay = tobs.TraceReplay(tracer.events())
    again = tcluster.simulate_cluster(replay.spec(spec), replay.trace(),
                                      autoalloc=cfg, seed=4242,
                                      max_attempts=max_attempts)
    _assert_results_equal(orig, again, attribution=False)
    if max_attempts == 2:
        assert any(r.status == "failed" for r in orig.records)


def test_replay_of_reference_trace_matches_reference(tmp_path):
    """The reference's recorded trace (written as JSONL) replayed by both
    packages, static with lost tasks."""
    tracer = jobs.Tracer()
    jcluster.simulate_cluster(jbackends.get("hq"),
                              jcluster.bursty_trace(2, 10, seed=3),
                              n_workers=2, walltime_s=120, seed=7,
                              tracer=tracer)
    path = str(tmp_path / "trace.jsonl")
    tracer.write_jsonl(path)
    jrep = jobs.TraceReplay.from_jsonl(path)
    trep = tobs.TraceReplay.from_jsonl(path)
    assert plain(jrep.summary()) == plain(trep.summary())
    assert plain(jrep.trace()) == plain(trep.trace())
    kw = dict(n_workers=2, walltime_s=120, seed=0)
    j = jobs.replay_cluster(jbackends.get("hq"), path, **kw)
    t = tobs.replay_cluster(tbackends.get("hq"), path, **kw)
    _assert_results_equal(j, t)
    assert any(r.status == "lost" for r in t.records)


# --------------------------------------------------------------------------
# the parity harness
# --------------------------------------------------------------------------
PARITY = {
    "static": lambda c: dict(n_workers=3),
    "elastic": lambda c: dict(autoalloc=c.AutoAllocConfig(**ELASTIC),
                              max_workers=16),
    "walltime": lambda c: dict(n_workers=1, walltime_s=60.0,
                               max_attempts=3),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_run_parity_matches_reference(name):
    reps = []
    for p in (J, T):
        reps.append(p.cluster.run_parity(
            p.backends.get("hq"), p.cluster.bimodal_trace(n=30, seed=4),
            seed=9, **PARITY[name](p.cluster)))
    jrep, trep = reps
    assert trep.ok, "\n".join(trep.divergences)
    assert jrep.ok == trep.ok
    _assert_results_equal(jrep.sim, trep.sim)
    _assert_results_equal(jrep.live, trep.live)


def test_run_parity_with_faults_matches_reference():
    reps = []
    for p in (J, T):
        plan = p.chaos.FaultPlan.generate(2, horizon_s=300.0,
                                          rates=FAULT_RATES)
        reps.append(p.cluster.run_parity(
            p.backends.get("hq"), p.cluster.bimodal_trace(n=30, seed=2),
            autoalloc=p.cluster.AutoAllocConfig(**ELASTIC), max_workers=8,
            seed=2, max_attempts=4, fault_plan=plan))
    assert reps[1].ok, "\n".join(reps[1].divergences)
    _assert_results_equal(reps[0].sim, reps[1].sim)
    _assert_results_equal(reps[0].live, reps[1].live)


def _surrogate_posterior(n_train=24, seed=0):
    """The GP of benchmarks/surrogate_offload.py: 2 outputs ~100x apart
    in scale, trained on [0, 1]^2."""
    rng = np.random.default_rng(seed)
    xs = rng.random((n_train, 2)).astype(np.float32)
    ys = np.stack([np.sin(3.0 * xs[:, 0]) + xs[:, 1],
                   100.0 * np.cos(2.0 * xs[:, 1]) + 10.0 * xs[:, 0]], 1)
    return jgp.fit(xs, ys.astype(np.float32), steps=60)


def _offload_trace(p, n, seed):
    """The recipe of benchmarks/surrogate_offload.py `make_trace`."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(n):
        t += float(rng.exponential(5.0))
        base = 120.0 if rng.uniform() < 0.4 else 4.0
        runtime = base * float(np.exp(0.3 * rng.standard_normal()))
        theta = (rng.random(2) if rng.uniform() < 0.7
                 else 2.0 + rng.random(2))
        out.append(p.cluster.TraceTask(
            t=t, runtime=runtime, model_name="gs2", time_request=base,
            parameters=[[float(theta[0]), float(theta[1])]]))
    return out


@pytest.fixture(scope="module")
def carried_surrogate(on_cpu):
    """(reference posterior, the same posterior on the port's CPU)."""
    jpost = _surrogate_posterior()
    return jpost, tgp.posterior_from_numpy(export_posterior(jpost), "cpu")


def test_run_parity_with_the_port_surrogate(carried_surrogate):
    """The port's GP offload on the broker: sim and live agree exactly."""
    _, tpost = carried_surrogate

    def factory():
        return tsched.SurrogateOffload(tpost, runtime_budget_s=30.0,
                                       sd_threshold=0.2)
    rep = tcluster.run_parity(tbackends.get("hq"), _offload_trace(T, 60, 3),
                              autoalloc=tcluster.AutoAllocConfig(**ELASTIC),
                              max_workers=16, seed=3,
                              surrogate_factory=factory)
    assert rep.ok, "\n".join(rep.divergences)
    offloaded = [r for r in rep.sim.records
                 if r.cpu_time == pytest.approx(0.05)]
    assert offloaded and all(r.status == "ok" for r in rep.sim.records)


# --------------------------------------------------------------------------
# the GP on the cluster path: runtime predictor + surrogate offload
# --------------------------------------------------------------------------
def test_simulate_cluster_gp_predictor_and_offload(carried_surrogate,
                                                   monkeypatch):
    """Both sides route on the same surrogate posterior and fit their
    runtime predictors with the reference's fit (carried, as in
    tests/test_torch_simulator.py), so trust sds differ only by the
    predict's arithmetic: the latent variance sd^2 is held at 1e-4
    (tests/test_torch_gp.py; sd itself is not, since d sd = d var / 2 sd
    grows where the GP is sure).  Decisions are held equal where both
    variances lie more than 1e-4 from threshold^2 and the cost gate
    answered alike; every task ends ok on both sides, and the offloaded
    counts differ by at most the tasks left out."""
    carry_reference_fit(monkeypatch)
    jpost, tpost = carried_surrogate
    thr, tol = 0.2, 1e-4
    runs = []
    for p, post in ((J, jpost), (T, tpost)):
        off = p.sched.SurrogateOffload(post, runtime_budget_s=30.0,
                                       sd_threshold=thr)
        log = record_decisions(off)
        broker = p.cluster.Broker(policy="sjf",
                                  predictor=p.sched.GPRuntimePredictor(),
                                  surrogate=off)
        res = p.cluster.simulate_cluster(
            p.backends.get("hq"), _offload_trace(p, 120, 7), broker=broker,
            n_workers=4, seed=7, registry=p.obs.MetricsRegistry())
        runs.append((res, off, log, broker.predictor))
    (jres, joff, jlog, jpred), (tres, toff, tlog, tpred) = runs
    assert sorted(r.task_id for r in tres.records) == \
        sorted(r.task_id for r in jres.records)
    assert all(r.status == "ok" for r in tres.records)
    assert jpred.n_fits == tpred.n_fits >= 2
    assert set(jlog) == set(tlog)
    compared = 0
    for tid, (jsd, jdec) in jlog.items():
        tsd, tdec = tlog[tid]
        if jsd is None and tsd is None:
            assert jdec is tdec is False
            compared += 1
        elif jsd is not None and tsd is not None:
            assert abs(tsd ** 2 - jsd ** 2) <= tol, (tid, jsd, tsd)
            if min(abs(jsd ** 2 - thr ** 2), abs(tsd ** 2 - thr ** 2)) > tol:
                assert jdec == tdec, (tid, jsd, tsd)
                compared += 1
    left_out = len(jlog) - compared
    assert left_out <= 0.05 * len(jlog), left_out
    assert abs(toff.stats().n_offloaded - joff.stats().n_offloaded) \
        <= left_out
    assert toff.stats().n_offloaded > 0


def test_simulate_cluster_offload_without_card_raises(carried_surrogate,
                                                      monkeypatch):
    """With the default device (CUDA) and no card, a surrogate on the
    broker stops the run instead of predicting on the CPU."""
    _, tpost = carried_surrogate
    broker = tcluster.Broker(surrogate=tsched.SurrogateOffload(tpost))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    device.set_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="set_device"):
            tcluster.simulate_cluster(tbackends.get("hq"),
                                      _offload_trace(T, 5, 0),
                                      broker=broker)
    finally:
        device.set_device("cpu")
