"""The port's simulator half of `core` and the paper's Table III, against
`repro`.

* `simulate` and `simulate_policy` are host code on numpy's seeded
  generator in both packages, so given the same runtimes the port's
  records equal the reference's field by field, exactly, for every
  backend, Table III workload, queue depth and seed, with predictors
  None and "quantile".
* The GS2 column is solved by each package's own GS2 proxy.  Its
  iteration counts are decided by f32 rounding of the stop test
  (tests/test_torch_gs2.py), so the two tables are compared at that
  test's count tolerance, and the record tests feed the reference's
  table to both simulators.
* The paper's claims (tests/test_scheduler.py:57-120) are held on the
  port's own GS2 table.
* With predictor="gp" the two sides fit the same data; the runtime
  predictions are held at 1e-4 and the summaries at the tolerances
  stated beside their asserts.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sched as jsched
import repro_torch.core as tcore
import repro_torch.sched as tsched
from repro.configs import workloads as jworkloads
from repro.uq import sampling
from repro_torch import device
from repro_torch.configs import workloads as tworkloads
from repro_torch.uq import gp as tgp
from torch_port_util import (assert_records_equal,  # noqa: F401
                             carry_reference_fit, on_cpu)

pytestmark = pytest.mark.usefixtures("on_cpu")

BACKENDS = ("slurm", "umb-slurm", "hq")


@pytest.fixture(scope="module")
def workloads_pair(on_cpu):
    """{bench: (reference Workload, port Workload)}; the port's gs2 column
    carries the reference's runtimes."""
    out = {}
    for bench in jworkloads.BENCHMARKS:
        jw = jworkloads.make_workload(bench)
        out[bench] = (jw, tcore.Workload(**dataclasses.asdict(jw)))
    return out


@pytest.fixture(scope="module")
def port_gs2(on_cpu):
    """The port's own Table III gs2 column (100 proxy solves)."""
    return tworkloads.make_workload("gs2")


# --------------------------------------------------------------------------
# backends and Table III
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", BACKENDS)
def test_backend_specs_match_reference(name):
    j, t = jcore.backends.get(name), tcore.backends.get(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.describe() == t.describe()
    for alloc, cpus in ((60.0, 1), (14400.0, 8), (2_160_000.0, 8)):
        assert j.queue_wait_median(alloc, cpus) == \
            t.queue_wait_median(alloc, cpus)
        assert j.draw_queue_wait(np.random.default_rng(3), alloc, cpus) == \
            t.draw_queue_wait(np.random.default_rng(3), alloc, cpus)


@pytest.mark.parametrize("bench", ["eigen-100", "eigen-5000", "gp"])
@pytest.mark.parametrize("seed", [0, 5])
def test_jittered_workloads_match_reference(bench, seed):
    j = jworkloads.make_workload(bench, n_evals=40, seed=seed)
    t = tworkloads.make_workload(bench, n_evals=40, seed=seed)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_gs2_table_within_the_iteration_count_tolerance(workloads_pair,
                                                       port_gs2):
    """runtime = clip(scale * its^2): the iteration-count tolerance of
    test_growth_frequency_iterations_match_reference (90% of counts within
    15%, rank correlation >= 0.9) is a runtime ratio within
    [0.85^2, 1.15^2] (clipping only narrows it)."""
    want = np.asarray(workloads_pair["gs2"][0].runtimes)
    got = np.asarray(port_gs2.runtimes)
    assert got.shape == want.shape == (jworkloads.N_EVALS,)
    ratio = got / want
    assert np.mean((ratio >= 0.85 ** 2) & (ratio <= 1.15 ** 2)) >= 0.9, ratio
    rank = np.corrcoef(np.argsort(np.argsort(got)),
                       np.argsort(np.argsort(want)))[0, 1]
    assert rank >= 0.9, rank
    jw = dataclasses.replace(workloads_pair["gs2"][0], runtimes=())
    tw = dataclasses.replace(port_gs2, runtimes=())
    assert dataclasses.asdict(jw) == dataclasses.asdict(tw)


def test_resource_table_matches_reference(port_gs2):
    j, t = jworkloads.resource_table(), tworkloads.resource_table()
    assert list(j) == list(t)
    for bench in j:
        for key in j[bench]:
            if bench == "gs2" and key == "expected_tts_min":
                # the mean of each package's own gs2 column
                assert t[bench][key] == float(np.mean(port_gs2.runtimes)) / 60
            else:
                assert t[bench][key] == j[bench][key], (bench, key)


# --------------------------------------------------------------------------
# simulate / simulate_policy: exact records
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("bench", jworkloads.BENCHMARKS)
@pytest.mark.parametrize("q", jworkloads.QUEUE_DEPTHS)
@pytest.mark.parametrize("seed", [0, 7, 31])
def test_simulate_records_match_reference(workloads_pair, backend, bench, q,
                                          seed):
    jw, tw = workloads_pair[bench]
    jrecs = jcore.simulate(jcore.backends.get(backend), jw, q, seed=seed)
    trecs = tcore.simulate(tcore.backends.get(backend), tw, q, seed=seed)
    assert_records_equal(jrecs, trecs)
    assert_records_equal(jcore.eval_records(jrecs),
                         tcore.eval_records(trecs))
    js = jcore.metrics.summarize(bench, backend, jcore.eval_records(jrecs))
    ts = tcore.metrics.summarize(bench, backend, tcore.eval_records(trecs))
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)


# (predictor, policy, hints): the predictor-free and quantile paths, with
# the workload's time request, no hint and oracle hints
POLICY_CASES = [(None, "fcfs", "workload"), ("quantile", "sjf", None),
                ("quantile", "pack", "workload"), (None, "lpt", "oracle")]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("bench", jworkloads.BENCHMARKS)
@pytest.mark.parametrize("predictor,policy,hints", POLICY_CASES)
def test_simulate_policy_records_match_reference(workloads_pair, backend,
                                                 bench, predictor, policy,
                                                 hints):
    jw, tw = workloads_pair[bench]
    kw = dict(n_workers=4, policy=policy, predictor=predictor, seed=11,
              hints=hints)
    assert_records_equal(
        jcore.simulate_policy(jcore.backends.get(backend), jw, **kw),
        tcore.simulate_policy(tcore.backends.get(backend), tw, **kw))


@pytest.mark.parametrize("policy", ["steal", "pack", "edf"])
def test_simulate_policy_multi_model_with_parameters(policy):
    """Per-task hints, LHS parameters and two model names (warm-server
    bookkeeping and renewal of a short bulk allocation)."""
    rng = np.random.default_rng(4)
    runtimes = tuple(float(v) for v in rng.lognormal(3.0, 1.0, 60))
    fields = dict(name="mix", runtimes=runtimes, hq_alloc=400.0,
                  time_limit=200.0)
    jw, tw = jcore.Workload(**fields), tcore.Workload(**fields)
    kw = dict(n_workers=3, policy=policy, predictor="quantile", seed=2,
              hints=[r * 1.3 for r in runtimes],
              parameters=sampling.latin_hypercube(60, seed=9),
              model_names=["a" if i % 3 else "b" for i in range(60)])
    for backend in BACKENDS:
        assert_records_equal(
            jcore.simulate_policy(jcore.backends.get(backend), jw, **kw),
            tcore.simulate_policy(tcore.backends.get(backend), tw, **kw))


@pytest.mark.parametrize("policy", ["sjf", "pack"])
def test_simulate_policy_gp_predictor_matches_reference(workloads_pair,
                                                        monkeypatch, policy):
    """GP-ordered schedules can swap two near-equal predictions, so the
    orders are not required to match.  Held: the final predictors'
    runtime predictions at 1e-4 relative (the predict tolerance of
    tests/test_torch_gp.py); total CPU to 1e-9 relative (on a bulk
    allocation with one model every task pays its own compute and each
    worker one server init, whatever the order); makespan within the
    longest task (Graham's bound: any two work-conserving list schedules
    of the same tasks on the same workers lie in [sum/W, sum/W + max]);
    median overhead (the median start) within the longest task likewise,
    since a swap of two tasks delays a later start by at most their
    runtime difference."""
    carry_reference_fit(monkeypatch)
    jw, tw = workloads_pair["gs2"]
    params = sampling.latin_hypercube(jw.n_tasks, seed=42)
    jpred, tpred = jsched.GPRuntimePredictor(), tsched.GPRuntimePredictor()
    kw = dict(n_workers=2, policy=policy, seed=7, parameters=params)
    jrecs = jcore.simulate_policy(jcore.backends.get("hq"), jw,
                                  predictor=jpred, **kw)
    trecs = tcore.simulate_policy(tcore.backends.get("hq"), tw,
                                  predictor=tpred, **kw)
    assert jpred.n_fits == tpred.n_fits >= 3
    reqs = [jcore.EvalRequest("gs2", [list(map(float, p))]) for p in params]
    want = np.asarray(jpred.predict_many(reqs))
    got = np.asarray(tpred.predict_many(reqs))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    js = jcore.metrics.summarize("gs2", "hq", jrecs)
    ts = tcore.metrics.summarize("gs2", "hq", trecs)
    longest = max(jw.runtimes)
    assert ts.total_cpu_time == pytest.approx(js.total_cpu_time, rel=1e-9)
    assert abs(ts.makespan - js.makespan) <= longest
    assert abs(ts.overhead_stats["median"]
               - js.overhead_stats["median"]) <= longest
    assert sorted(r.task_id for r in trecs) == \
        sorted(r.task_id for r in jrecs)
    assert all(r.status == "ok" for r in trecs)


# --------------------------------------------------------------------------
# the paper's claims on the port's own GS2 table (twins of
# tests/test_scheduler.py:57-120)
# --------------------------------------------------------------------------
def _run(bench, backend, q, gs2=None, seed=7):
    w = gs2 if bench == "gs2" else tworkloads.make_workload(bench)
    recs = tcore.simulate(tcore.backends.get(backend), w, q, seed=seed)
    return tcore.metrics.summarize(bench, backend, tcore.eval_records(recs))


@pytest.mark.parametrize("q", [2, 10])
def test_port_claim_gs2_makespan_reduction_38pct(port_gs2, q):
    s = _run("gs2", "slurm", q, port_gs2)
    h = _run("gs2", "hq", q, port_gs2)
    red = 1 - h.makespan / s.makespan
    assert 0.28 <= red <= 0.48, red          # paper: ~38 % both settings


def test_port_claim_overhead_three_orders(port_gs2):
    for bench, floor in [("gs2", 1e3), ("eigen-5000", 1e3),
                         ("eigen-100", 300.0)]:
        s = _run(bench, "slurm", 2, port_gs2)
        h = _run(bench, "hq", 2, port_gs2)
        ratio = s.overhead_stats["median"] / max(h.overhead_stats["median"],
                                                 1e-9)
        assert ratio >= floor, (bench, ratio)


def test_port_claim_eigen100_hq_3x_quicker():
    s = _run("eigen-100", "slurm", 2)
    h = _run("eigen-100", "hq", 2)
    assert 2.0 <= s.makespan / h.makespan <= 6.0   # paper: "roughly 3x"


def test_port_claim_hq_loses_cpu_time_on_short_tasks(port_gs2):
    s100, h100 = _run("eigen-100", "slurm", 2), _run("eigen-100", "hq", 2)
    assert h100.total_cpu_time > s100.total_cpu_time
    sgs2 = _run("gs2", "slurm", 10, port_gs2)
    hgs2 = _run("gs2", "hq", 10, port_gs2)
    assert hgs2.total_cpu_time < sgs2.total_cpu_time


def test_port_claim_slr_ordering():
    s = _run("eigen-100", "slurm", 2)
    h = _run("eigen-100", "hq", 2)
    assert h.slr < 2.0
    assert s.slr > 2.0 * h.slr


def test_port_claim_umb_slurm_no_gain(port_gs2):
    for q in (2, 10):
        s = _run("gs2", "slurm", q, port_gs2)
        u = _run("gs2", "umb-slurm", q, port_gs2)
        assert u.makespan >= 0.95 * s.makespan


def test_port_hq_finishes_first_in_most_benchmarks(port_gs2):
    wins = 0
    for bench in tworkloads.BENCHMARKS:
        for q in tworkloads.QUEUE_DEPTHS:
            if _run(bench, "hq", q, port_gs2).makespan < \
                    _run(bench, "slurm", q, port_gs2).makespan:
                wins += 1
    assert wins >= 7, wins             # paper: 'majority finished first'


# --------------------------------------------------------------------------
# structure (twins of the simulator tests of tests/test_scheduler.py)
# --------------------------------------------------------------------------
def test_port_simulator_respects_queue_depth():
    w = tworkloads.make_workload("eigen-5000")
    recs = tcore.eval_records(tcore.simulate(tcore.backends.get("slurm"), w,
                                             2, seed=1))
    events = sorted([(r.submit_t, 1) for r in recs] +
                    [(r.end_t, -1) for r in recs])
    depth, worst = 0, 0
    for _, d in events:
        depth += d
        worst = max(worst, depth)
    assert worst <= 2


def test_port_timeout_mechanism():
    w = tcore.Workload("t", runtimes=(10.0, 500.0), time_limit=60.0,
                       hq_alloc=600.0)
    recs = tcore.eval_records(tcore.simulate(tcore.backends.get("hq"), w, 1,
                                             seed=0))
    statuses = {r.task_id.split("-")[-1]: r.status for r in recs}
    assert statuses["0"] == "ok" and statuses["1"] == "timeout"
    assert max(r.cpu_time for r in recs) <= 60.0 + 1e-9


# --------------------------------------------------------------------------
# the LoadBalancer facade
# --------------------------------------------------------------------------
def _toy_factory(core):
    def factory():
        return core.LambdaModel("toy", lambda p, c: [[float(p[0][0]) * 2]],
                                1, 1)
    return factory


def test_port_balancer_readiness_and_health():
    """Twin of test_balancer_readiness_and_health."""
    with tcore.LoadBalancer("hq", n_workers=2) as lb:
        info = lb.register_model("toy", _toy_factory(tcore))
        assert info.probes_run == 5
        assert lb.evaluate("toy", [[21]])[0][0] == 42.0
        assert lb.health_check("toy", [[1]])
        with pytest.raises(KeyError):
            lb.submit(tcore.EvalRequest("nope", [[1]]))


@pytest.mark.parametrize("backend", ["hq", "slurm"])
def test_port_balancer_matches_reference(backend):
    """Both facades: same registration info, same values, same executor
    mode and policy/predictor objects picked by name."""
    out = []
    for core in (jcore, tcore):
        with core.LoadBalancer(backend, n_workers=2, policy="sjf",
                               predictor="quantile") as lb:
            info = lb.register_model("toy", _toy_factory(core))
            reqs = [core.EvalRequest("toy", [[i]]) for i in range(6)]
            vals = [r.value[0][0] for r in lb.run_all(reqs, timeout=60)]
            out.append((info.input_sizes, info.output_sizes, info.probes_run,
                        vals, lb.executor.persistent_servers,
                        lb.policy.name, type(lb.predictor).__name__,
                        len(lb.records())))
        assert lb.executor is None and lb.records() == []
    assert out[0] == out[1]


# --------------------------------------------------------------------------
# no fallback: the paths that reach the GP or the GS2 proxy
# --------------------------------------------------------------------------
def _gp_predictor_fit():
    w = tcore.Workload("w", runtimes=tuple(float(v) for v in
                                           np.linspace(10, 50, 12)))
    tcore.simulate_policy(tcore.backends.get("hq"), w, n_workers=2,
                          policy="sjf", predictor="gp",
                          parameters=sampling.latin_hypercube(12, seed=1))


def _balancer_gp_surrogate():
    def factory():
        post = tgp.fit(sampling.latin_hypercube(8, seed=0),
                       np.arange(8.0), steps=2)
        return tcore.LambdaModel("gp", lambda p, c: [[0.0]], 7, 1,
                                 warmup_fn=lambda: post)
    with tcore.LoadBalancer("hq", n_workers=1) as lb:
        lb.register_model("gp", factory)


@pytest.mark.parametrize("path", ["gs2_workload", "gp_predictor",
                                  "balancer_gp"])
def test_gp_and_gs2_paths_without_card_raise(monkeypatch, path):
    """With the default device (CUDA) and no card, the GS2 table, a GP
    runtime predictor once it fits and a LoadBalancer serving a GP
    surrogate raise instead of running on the CPU."""
    fn = {"gs2_workload": lambda: tworkloads.make_workload("gs2", n_evals=3,
                                                           seed=5),
          "gp_predictor": _gp_predictor_fit,
          "balancer_gp": _balancer_gp_surrogate}[path]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    device.set_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="set_device"):
            fn()
    finally:
        device.set_device("cpu")
