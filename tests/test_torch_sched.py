"""The port's scheduler copies and the slice as a whole, against `repro`.

* Seeded op traces (built as tests/test_queue_equivalence.py builds
  them) go through each `repro.sched` policy and its `repro_torch.sched`
  copy: pop order and pending snapshots must be identical.
* The offload router and runtime predictor on the port's engine.
* A small end-to-end run — 24 GS2 solves at m=48 through both packages'
  executors, a GP fitted by the reference and carried across — matched
  against the JAX pipeline.
* The port loads neither `jax` nor `repro` (checked in a subprocess), and
  with the default device and no card an entry point raises.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sched as jsched
import repro_torch.core as tcore
import repro_torch.sched as tsched
from repro.uq import gp as jgp
from repro.uq import gs2_proxy as jgs2
from repro.uq import sampling
from repro_torch import device
from repro_torch.uq import gp as tgp
from repro_torch.uq import gs2_proxy as tgs2
from torch_port_util import export_posterior, np32, on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

MODELS = ("gs2", "proxy", "cheap")
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _req_fields(i, rng):
    """The randomised request of test_queue_equivalence.py, as fields."""
    kind = rng.integers(0, 4)
    params = [[float(rng.uniform(0, 1)), float(rng.uniform(0, 1))]]
    if kind == 0:
        params = "not-numeric"
    return dict(
        model_name=MODELS[int(rng.integers(0, len(MODELS)))],
        parameters=params,
        time_request=(float(rng.uniform(0.5, 60.0))
                      if rng.random() < 0.8 else None),
        deadline=(float(rng.uniform(0, 500.0))
                  if rng.random() < 0.5 else None),
        task_id=f"eq-{i}")


def _both(fields):
    return jcore.EvalRequest(**fields), tcore.EvalRequest(**fields)


def _ids(items):
    return [(r.task_id, a) for r, a in items]


def _drive(name, seed, n_ops=400, quantile=False):
    rng = np.random.default_rng(seed)
    preds = ((jsched.QuantileEstimator(min_observed=1),
              tsched.QuantileEstimator(min_observed=1)) if quantile
             else (None, None))
    jpol = jsched.make_policy(name, preds[0])
    tpol = tsched.make_policy(name, preds[1])
    wids = [0, 1, 2, 3]
    pushed = 0
    for op_i in range(n_ops):
        op = rng.random()
        if op < 0.45:
            jr, tr = _both(_req_fields(f"{name}-{seed}-{pushed}", rng))
            pushed += 1
            attempt = int(rng.integers(1, 3))
            jpol.push(jr, attempt)
            tpol.push(tr, attempt)
        elif op < 0.85:
            if rng.random() < 0.25:
                jv = tv = None
            else:
                warm = frozenset(m for m in MODELS if rng.random() < 0.4)
                budget = (float(rng.uniform(0.0, 80.0))
                          if rng.random() < 0.6 else None)
                wid = int(rng.choice(wids))
                jv = jsched.WorkerView(wid=wid, warm_models=warm,
                                       budget_left=budget)
                tv = tsched.WorkerView(wid=wid, warm_models=warm,
                                       budget_left=budget)
            a, b = jpol.pop(jv), tpol.pop(tv)
            assert (a is None) == (b is None), (name, seed, op_i)
            if a is not None:
                assert (a[0].task_id, a[1]) == (b[0].task_id, b[1])
        elif op < 0.90 and name == "steal":
            wid = int(rng.choice(wids))
            jpol.remove_worker(wid)
            tpol.remove_worker(wid)
        elif quantile:
            jr, tr = _both(_req_fields(f"{name}-{seed}-obs-{op_i}", rng))
            t = float(rng.uniform(0.1, 50.0))
            preds[0].observe(jr, t)
            preds[1].observe(tr, t)
        if op_i % 37 == 0:
            assert _ids(jpol.pending()) == _ids(tpol.pending())
        assert len(jpol) == len(tpol)
    while True:
        a = jpol.pop(jsched.WorkerView(wid=0, budget_left=25.0))
        b = tpol.pop(tsched.WorkerView(wid=0, budget_left=25.0))
        assert (a is None) == (b is None)
        if a is None:
            break
        assert (a[0].task_id, a[1]) == (b[0].task_id, b[1])


@pytest.mark.parametrize("name", ["fcfs", "sjf", "lpt", "pack", "steal",
                                  "edf"])
@pytest.mark.parametrize("seed", [0, 7])
def test_pop_order_matches_reference(name, seed):
    _drive(name, seed)


@pytest.mark.parametrize("name", ["sjf", "lpt", "pack"])
def test_pop_order_matches_reference_with_online_predictor(name):
    _drive(name, 3, quantile=True)


def test_gp_predictor_batched_matches_single_and_shapes():
    """Twin of the reference's predict_many/predict and shape-discipline
    checks, on the port's engine."""
    rng = np.random.default_rng(4)
    pred = tsched.GPRuntimePredictor(min_fit=8, refit_every=1000,
                                     fit_steps=30)
    for x in rng.uniform(0, 1, size=(16, 2)):
        pred.observe(tcore.EvalRequest("m", [list(map(float, x))]),
                     0.5 + 2.0 * x[0] + x[1])
    assert pred.n_fits >= 1
    reqs = [tcore.EvalRequest("m", [list(map(float, x))])
            for x in rng.uniform(0.2, 0.8, size=(300, 2))]
    reqs.append(tcore.EvalRequest("m", "junk-params"))
    before = dict(tgp.predict_batch_shapes)
    many = pred.predict_many(reqs)
    launched = {k: v - before.get(k, 0) for k, v in
                tgp.predict_batch_shapes.items() if v != before.get(k, 0)}
    assert sorted(b for _, b in launched) == \
        sorted(set(tgp.bucket_launches(300)))
    single = [pred.predict(r) for r in reqs]
    assert many[-1] == single[-1]
    np.testing.assert_allclose(many[:-1], single[:-1], rtol=1e-3)
    with_sd = pred.predict_many_with_sd(reqs)
    np.testing.assert_allclose([m for m, _ in with_sd[:-1]], many[:-1],
                               rtol=1e-6)
    assert all(sd > 0 for _, sd in with_sd[:-1])
    pack = tsched.PackingPolicy(pred, risk_lambda=1.0)
    costs = pack.costs(reqs)
    assert all(c >= m for c, m in zip(costs[:-1], many[:-1]))


@pytest.fixture(scope="module")
def gs2_pipeline(on_cpu):
    """24 GS2 solves at m=48 through both executors (4 persistent
    workers), then a GP fitted by the reference on the results."""
    thetas = sampling.latin_hypercube(24, seed=11)

    def run(core, solver_of):
        def factory():
            solver = solver_of()

            def fn(parameters, config):
                return [list(solver(np.asarray(parameters[0], np.float32)))]
            return core.LambdaModel("gs2", fn, 7, 2)

        with core.Executor({"gs2": factory}, n_workers=4,
                           predictor="gp") as ex:
            reqs = [core.EvalRequest("gs2", [t.tolist()]) for t in thetas]
            res = {r.task_id: r for r in ex.run_all(reqs, timeout=300)}
            return np.array([res[r.task_id].value[0] for r in reqs]), ex

    jy, _ = run(jcore, lambda: jgs2.make_solver(m=48))
    ty, tex = run(tcore, lambda: tgs2.make_solver(m=48))
    jpost = jgp.fit(thetas, jy, steps=100)
    return thetas, jy, ty, jpost, tex


def test_end_to_end_outputs_match_reference(gs2_pipeline):
    """Same GS2 outputs from both executors, at the GS2 tolerances of
    test_torch_gs2.py."""
    _, jy, ty, _, tex = gs2_pipeline
    assert ty.shape == jy.shape == (24, 2)
    np.testing.assert_allclose(ty[:, 0], jy[:, 0], rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(ty[:, 1], jy[:, 1], rtol=2e-3,
                               atol=1e-7 + 2e-3 * np.abs(jy[:, 1]).max())
    assert len(tex.records()) == 24
    assert tex.predictor.n_fits >= 1          # the port's GP ran live


def test_end_to_end_carried_gp_predicts_like_reference(gs2_pipeline):
    """The reference's GP carried across predicts the same at 1e-4
    (relative to each output's scale), through predict, predict_batch
    and the offload router."""
    thetas, _, _, jpost, _ = gs2_pipeline
    tpost = tgp.posterior_from_numpy(export_posterior(jpost), "cpu")
    xq = sampling.latin_hypercube(300, seed=5)
    scale = np.maximum(np.abs(np.asarray(jpost.y)).max(0), 1.0)
    for jf, tf in ((jgp.predict, tgp.predict),
                   (jgp.predict_batch, tgp.predict_batch)):
        jm, jv = jf(jpost, xq)
        tm, tv = tf(tpost, xq)
        np.testing.assert_allclose(np32(tm) / scale, np32(jm) / scale,
                                   atol=1e-4)
        np.testing.assert_allclose(np32(tv) / scale ** 2,
                                   np32(jv) / scale ** 2, atol=1e-4)
    joff = jsched.SurrogateOffload(jpost, sd_threshold=0.3)
    toff = tsched.SurrogateOffload(tpost, sd_threshold=0.3)
    np.testing.assert_allclose(toff.trust_sd(xq), joff.trust_sd(xq),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.array(toff.evaluate([thetas[0].tolist()])),
                               np.array(joff.evaluate([thetas[0].tolist()])),
                               atol=1e-4 * scale.max(), rtol=1e-4)
    for i, theta in enumerate(xq[:40]):
        jr = jcore.EvalRequest("gs2", [theta.tolist()], task_id=f"o{i}")
        tr = tcore.EvalRequest("gs2", [theta.tolist()], task_id=f"o{i}")
        sd = float(joff.trust_sd([theta])[0])
        if abs(sd - 0.3) > 1e-3:              # not on the threshold
            assert joff.decide(jr, 100.0) == toff.decide(tr, 100.0)
    assert toff.n_offloaded == joff.n_offloaded


def test_port_loads_neither_jax_nor_repro(tmp_path):
    """The GS2 -> executor -> GP -> re-cost/offload -> QoI path on the
    port, then the simulators on every Table III workload, the cluster
    simulation with a fault plan and the offload, replay, the parity
    harness (through the package's lazy export, traced), the LoadBalancer,
    adaptive delegation and MCMC, in a fresh interpreter: no `jax` or
    `repro` module is loaded, lazy imports included."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        from repro_torch import device
        device.set_device("cpu")
        from repro_torch.core import EvalRequest, Executor, LambdaModel
        from repro_torch.sched import PackingPolicy, SurrogateOffload
        from repro_torch.uq import engine, gp, gs2_proxy, qoi, sampling

        thetas = sampling.latin_hypercube(10, seed=1)

        def factory():
            solver = gs2_proxy.make_solver(m=16)
            return LambdaModel("gs2", lambda p, c: [list(solver(p[0]))], 7, 2)

        with Executor({"gs2": factory}, n_workers=2, predictor="gp") as ex:
            reqs = [EvalRequest("gs2", [t.tolist()]) for t in thetas]
            y = np.array([r.value[0] for r in ex.run_all(reqs)])
            costs = PackingPolicy(ex.predictor, risk_lambda=1.0).costs(reqs)
        post = gp.fit(thetas, y, steps=10)
        off = SurrogateOffload(post, backend="incremental")
        sd = off.trust_sd(thetas)
        part = engine.fit_engine(thetas, y, "partitioned", steps=5,
                                 expert_cap=4)
        part.predict_batch(thetas)
        qoi.quadrature(lambda x: tuple(float(v) for v in
                                       gp.predict(post, x)[0][0]),
                       thetas[0], n_ky=3, n_theta0=3)

        import repro_torch.cluster as cluster
        from repro_torch.chaos import FaultPlan, InvariantChecker
        from repro_torch.configs import workloads
        from repro_torch.core import LoadBalancer, backends, simulate
        from repro_torch.obs import Tracer, replay_cluster
        from repro_torch.uq import adaptive, mcmc
        from repro_torch.uq.eigen import EigenModel

        hq = backends.get("hq")
        for bench in workloads.BENCHMARKS:
            w = workloads.make_workload(bench, n_evals=6)
            assert len(simulate(hq, w, 2, seed=7)) == 6 + hq.preliminary_jobs
        trace = [cluster.TraceTask(t=2.0 * i, runtime=30.0 + i,
                                   model_name="gs2", time_request=30.0,
                                   parameters=[t.tolist()])
                 for i, t in enumerate(thetas)]
        plan = FaultPlan.generate(0, horizon_s=40.0,
                                  rates={"worker_crash": 0.05})
        broker = cluster.Broker(surrogate=SurrogateOffload(
            post, runtime_budget_s=1.0, sd_threshold=10.0))
        tracer = Tracer()
        res = cluster.simulate_cluster(hq, trace, broker=broker,
                                       n_workers=2, fault_plan=plan,
                                       tracer=tracer)
        assert InvariantChecker().check(records=res.records,
                                        allocations=res.allocations,
                                        events=tracer.events()).ok
        again = replay_cluster(hq, tracer.events(), n_workers=2)
        assert len(again.records) == len(res.records)
        rep = cluster.run_parity(hq, cluster.bimodal_trace(n=6, seed=1),
                                 n_workers=2, tracers=(Tracer(), Tracer()))
        assert rep.ok, rep.divergences
        with LoadBalancer("hq", n_workers=2) as lb:
            lb.register_model("eigen-16", lambda: EigenModel(16))
            lb.register_model("gs2", factory)
            assert len(lb.evaluate("eigen-16", [[0]])[0]) == 2
            stream = adaptive.evaluate_stream(lb.executor, "gs2", post,
                                              thetas[:3], sd_threshold=0.0,
                                              backend="incremental")
            assert stream.n_sim_calls == 3
            chain = mcmc.run_chain(lb.executor, "eigen-16", x0=np.zeros(1),
                                   bounds=[(0.0, 1.0)], observed=[0.0, 1.0],
                                   n_steps=3)
            assert chain.n_evals == 4
        loaded = sorted(m for m in sys.modules
                        if m in ("jax", "repro") or m.startswith("jax.")
                        or m.startswith("repro."))
        assert len(costs) == 10 and len(sd) == 10
        print("LOADED", loaded)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_service_loads_neither_jax_nor_repro(tmp_path):
    """`repro_torch.service` and `repro_torch.checkpoint` in a fresh
    interpreter: a `ServiceBroker` with `predictor="gp"` fits its runtime
    GP, is killed mid-workload and recovered from its journal (the
    predictor refitted from the journal's conditioning set) with every
    task ok, and no `jax` or `repro` module is loaded."""
    script = textwrap.dedent("""
        import sys, time
        from repro_torch import device
        device.set_device("cpu")
        from repro_torch.checkpoint import Journal
        from repro_torch.core import EvalRequest, LambdaModel
        from repro_torch.service import ServiceBroker

        def factory():
            def fn(p, c):
                time.sleep(0.002 + 0.004 * p[0][0])
                return [[p[0][0] + p[0][1]]]
            return LambdaModel("toy", fn, 2, 1)

        kw = dict(predictor="gp", n_workers=2)
        svc = ServiceBroker({"toy": factory}, weights={"a": 1.0, "b": 2.0},
                            journal_dir=sys.argv[1], journal_every_s=0.02,
                            **kw)
        ids = [svc.submit(EvalRequest("toy", [[i / 20, 1 - i / 20]],
                                      tenant="ab"[i % 2],
                                      task_id=f"t{i}")) for i in range(20)]
        while svc._ex.predictor.n_fits < 1 or \\
                sum(r.status == "ok" for r in svc.records()) < 10:
            time.sleep(0.01)
        svc.checkpoint()
        svc.kill()
        assert len(Journal(sys.argv[1]).latest()[1]["snapshot"]
                   ["predictor"]["xs"]) >= 8
        svc2 = ServiceBroker.recover({"toy": factory},
                                     journal_dir=sys.argv[1], **kw)
        assert svc2._ex.predictor.n_fits >= 1
        res = [svc2.result(t, timeout=60) for t in ids]
        svc2.shutdown()
        assert [r.status for r in res] == ["ok"] * 20
        loaded = sorted(m for m in sys.modules
                        if m in ("jax", "repro") or m.startswith("jax.")
                        or m.startswith("repro."))
        print("LOADED", loaded)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", script,
                          str(tmp_path / "journal")], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_default_device_without_card_raises(monkeypatch):
    """With the default device (CUDA) and no card, entry points raise
    rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    device.set_device("cuda")
    try:
        x = np.zeros((4, 2), np.float32)
        with pytest.raises(RuntimeError, match="set_device"):
            tgp.fit(x, np.arange(4.0), steps=1)
        with pytest.raises(RuntimeError, match="set_device"):
            tgs2.evaluate(np.full(7, 0.5), 16)
        with pytest.raises(RuntimeError, match="set_device"):
            device.get()
    finally:
        device.set_device("cpu")
