"""The port's UQ workflows of paper §VI (eigen tasks, dependent-task MCMC,
adaptive surrogate delegation) against `repro`.

* `EigenModel` solves with numpy's LAPACK in both packages, and the MCMC
  chains run a numpy model through each package's `Executor` on
  identically seeded generators: held exactly.
* Adaptive delegation starts from the reference's posterior of
  tests/test_uq_workflows.py carried to the port, on the exact,
  incremental and partitioned engines, and conditions it on each
  simulator run.  Each side re-factorises in its own f32 arithmetic, and
  that GP is fitted to a noiseless model (noise at its floor, cond(K)
  ~ 2e6), so the outputs and the gate's variance are held with the pin
  tests/test_torch_engine.py holds the engines to over a conditioning
  stream: per column, 5e-4 + 1e-3 * max(range, 1).  Each delegation
  decision is held equal wherever the variance at that step lies more
  than that pin from threshold^2 on both sides (a decision nearer than
  that may flip, and the streams are compared up to it).  The pin is a
  property of that ill-conditioned input, not of the port: the same
  stream from a GP fitted to noisy observations of the model (noise sd
  0.7, its K well conditioned) is held over the whole stream at 1e-4,
  the gate's variance absolute and the outputs relative to max(|y|, 1),
  with every decision equal.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.uq import adaptive as jadaptive
from repro.uq import eigen as jeigen
from repro.uq import gp as jgp
from repro.uq import mcmc as jmcmc
from repro_torch import device
from repro_torch.uq import adaptive as tadaptive
from repro_torch.uq import eigen as teigen
from repro_torch.uq import gp as tgp
from repro_torch.uq import mcmc as tmcmc
from torch_port_util import export_posterior, np32, on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

BOUNDS = [(-2.0, 2.0), (-2.0, 2.0)]
TRUTH = np.array([0.8, -0.5])
OBSERVED = [TRUTH[0] ** 2 + TRUTH[1], TRUTH[0] - TRUTH[1] ** 2]


def _quad(x):
    return [float(x[0] ** 2 + x[1]), float(x[0] - x[1] ** 2)]


def _quad_factory(core):
    """Cheap analytic forward model: F(x) = [x0^2 + x1, x0 - x1^2]."""
    def factory():
        return core.LambdaModel(
            "quad", lambda p, c: [_quad(np.asarray(p[0], float))], 2, 2)
    return factory


# --------------------------------------------------------------------------
# eigen tasks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [16, 100])
@pytest.mark.parametrize("fixed_seed", [0, None])
def test_eigen_model_matches_reference(n, fixed_seed):
    jm, tm = jeigen.EigenModel(n, fixed_seed), teigen.EigenModel(n, fixed_seed)
    assert (tm.name, tm.get_input_sizes(), tm.get_output_sizes()) == \
        (jm.name, jm.get_input_sizes(), jm.get_output_sizes())
    assert tm.cost_hint([[0]]) == jm.cost_hint([[0]])
    tm.warmup()
    for seed in (0, 3, 7):
        assert tm([[seed]]) == jm([[seed]])
    np.testing.assert_array_equal(teigen.make_matrix(n, 5),
                                  jeigen.make_matrix(n, 5))


def test_eigen_model_through_the_port_executor():
    with tcore.Executor({"eigen-100": lambda: teigen.EigenModel(100)},
                        n_workers=2) as ex:
        res = ex.run_all([tcore.EvalRequest("eigen-100", [[0]])
                          for _ in range(6)])
    want = jeigen.EigenModel(100)([[0]])
    assert all(r.status == "ok" and r.value == want for r in res)


# --------------------------------------------------------------------------
# MCMC
# --------------------------------------------------------------------------
def _chain(core, mcmc, n_steps, seed, step_scale):
    with core.Executor({"quad": _quad_factory(core)}, n_workers=2) as ex:
        return mcmc.run_chain(ex, "quad", x0=np.array([0.0, 0.0]),
                              bounds=BOUNDS, observed=OBSERVED,
                              n_steps=n_steps, step_scale=step_scale,
                              sigma=0.1, seed=seed)


@pytest.mark.parametrize("seed,step_scale", [(3, 0.03), (8, 0.1)])
def test_mcmc_chain_matches_reference(seed, step_scale):
    j = _chain(jcore, jmcmc, 60, seed, step_scale)
    t = _chain(tcore, tmcmc, 60, seed, step_scale)
    np.testing.assert_array_equal(t.samples, j.samples)
    np.testing.assert_array_equal(t.log_likelihoods, j.log_likelihoods)
    assert (t.accept_rate, t.n_evals) == (j.accept_rate, j.n_evals)


def test_port_mcmc_chain_converges_toward_posterior():
    """Twin of test_mcmc_chain_converges_toward_posterior."""
    res = _chain(tcore, tmcmc, 120, 3, 0.03)
    assert res.n_evals == 121
    assert 0.05 < res.accept_rate < 0.95
    first, second = res.log_likelihoods[:40], res.log_likelihoods[-40:]
    assert second.mean() > first.mean()
    tail = res.samples[-40:]
    assert abs(np.median(tail[:, 0] ** 2 + tail[:, 1]) - OBSERVED[0]) < 0.3


def test_mcmc_chains_interleave_like_reference():
    out = []
    for core, mcmc in ((jcore, jmcmc), (tcore, tmcmc)):
        with core.Executor({"quad": _quad_factory(core)}, n_workers=3) as ex:
            out.append(mcmc.run_chains(
                ex, "quad", x0s=[np.zeros(2), np.ones(2) * 0.5],
                bounds=BOUNDS, observed=OBSERVED, n_steps=30,
                step_scale=0.1, sigma=0.1))
    assert len(out[1]) == 2 and all(r.n_evals == 31 for r in out[1])
    assert not np.allclose(out[1][0].samples, out[1][1].samples)
    for j, t in zip(*out):
        np.testing.assert_array_equal(t.samples, j.samples)
        assert t.accept_rate == j.accept_rate


def test_gaussian_loglike_matches_reference():
    out, obs = [0.3, -1.2], [0.1, -1.0]
    for sigma in (0.1, 1.0):
        assert tmcmc.gaussian_loglike(out, obs, sigma) == \
            jmcmc.gaussian_loglike(out, obs, sigma)


# --------------------------------------------------------------------------
# adaptive delegation
# --------------------------------------------------------------------------
class _Logged:
    """An engine that records the delegation gate's predictive sd (the
    max over outputs of sqrt(var)) at every predict, and stays logged
    across conditioning."""

    def __init__(self, eng, log):
        self._eng, self._log = eng, log

    def predict(self, x):
        mean, var = self._eng.predict(x)
        self._log.append(float(np.max(np.sqrt(np32(var)[0]))))
        return mean, var

    def condition(self, x, y):
        return _Logged(self._eng.condition(x, y), self._log)

    def __getattr__(self, name):
        return getattr(self._eng, name)


def _stream(core, adaptive, post, xs, backend, thr, monkeypatch):
    log = []
    as_engine = adaptive.engine_lib.as_engine
    monkeypatch.setattr(adaptive.engine_lib, "as_engine",
                        lambda p, b: _Logged(as_engine(p, b), log))
    with core.Executor({"quad": _quad_factory(core)}, n_workers=2) as ex:
        res = adaptive.evaluate_stream(ex, "quad", post, xs,
                                       sd_threshold=thr, backend=backend)
    monkeypatch.setattr(adaptive.engine_lib, "as_engine", as_engine)
    return res, log


@pytest.fixture(scope="module")
def quad_gp(on_cpu):
    """The reference's GP of the quad model (as in
    tests/test_uq_workflows.py) and the same posterior on the port."""
    rng = np.random.default_rng(0)
    xs = rng.uniform(-2, 2, (40, 2)).astype(np.float32)
    ys = np.stack([xs[:, 0] ** 2 + xs[:, 1], xs[:, 0] - xs[:, 1] ** 2], 1)
    jpost = jgp.fit(xs, ys, steps=200)
    return jpost, tgp.posterior_from_numpy(export_posterior(jpost), "cpu")


def _pin(want):
    """tests/test_torch_engine.py's pin, per column of `want`."""
    want = np.atleast_2d(np.asarray(want, float).T).T
    return 5e-4 + 1e-3 * np.maximum(np.ptp(want, axis=0), 1.0)


@pytest.mark.parametrize("backend", ["exact", "incremental", "partitioned"])
@pytest.mark.parametrize("thr", [0.1, 0.25])
def test_adaptive_matches_reference(quad_gp, monkeypatch, backend, thr):
    """Requests near the training data and far outside it, interleaved."""
    jpost, tpost = quad_gp
    rng = np.random.default_rng(1)
    xs = np.concatenate([rng.uniform(-1.5, 1.5, (14, 2)),
                         rng.uniform(2.5, 3.5, (6, 2))]).astype(np.float32)
    rng.shuffle(xs)
    j, jlog = _stream(jcore, jadaptive, jpost, xs, backend, thr, monkeypatch)
    t, tlog = _stream(tcore, tadaptive, tpost, xs, backend, thr, monkeypatch)
    assert len(jlog) == len(tlog) == len(xs)
    tol_var = float(_pin(np.square(jlog))[0])
    upto = len(xs)
    for i, (jsd, tsd) in enumerate(zip(jlog, tlog)):
        if j.used_simulator[i] != t.used_simulator[i]:
            # only a decision at the threshold may flip; after it the two
            # streams condition on different data
            assert min(abs(jsd ** 2 - thr ** 2),
                       abs(tsd ** 2 - thr ** 2)) <= tol_var, (i, jsd, tsd)
            upto = i
            break
        assert abs(tsd ** 2 - jsd ** 2) <= tol_var, (i, jsd, tsd)
    err = np.abs(t.outputs[:upto] - j.outputs[:upto]).max(axis=0)
    assert (err <= _pin(j.outputs)).all(), err
    sim = t.used_simulator[:upto]
    np.testing.assert_array_equal(t.outputs[:upto][sim],
                                  j.outputs[:upto][sim])
    if upto == len(xs):
        assert t.n_sim_calls == j.n_sim_calls
    assert 0 < t.n_sim_calls < len(xs)
    if backend == "partitioned":
        assert t.posterior.n_train() == len(tpost.x) + t.n_sim_calls
    else:
        assert isinstance(t.posterior, tgp.GPPosterior)
        assert t.posterior.x.shape[0] == len(tpost.x) + t.n_sim_calls


@pytest.fixture(scope="module")
def quad_gp_noisy(on_cpu):
    """A well-conditioned twin of `quad_gp`: 30 points of the quad model
    observed with noise of sd 0.7, so the fitted noise keeps K far from
    singular and both sides' f32 factorisations agree."""
    rng = np.random.default_rng(0)
    xs = rng.uniform(-2, 2, (30, 2)).astype(np.float32)
    ys = np.stack([xs[:, 0] ** 2 + xs[:, 1], xs[:, 0] - xs[:, 1] ** 2], 1)
    ys = (ys + 0.7 * rng.standard_normal(ys.shape)).astype(np.float32)
    jpost = jgp.fit(xs, ys, steps=200)
    return jpost, tgp.posterior_from_numpy(export_posterior(jpost), "cpu")


@pytest.mark.parametrize("backend", ["exact", "incremental", "partitioned"])
@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_adaptive_matches_reference_well_conditioned(
        quad_gp_noisy, monkeypatch, backend, thr):
    """The stream of test_adaptive_matches_reference on the noisy fit,
    compared over every request: the gate's variance (sd^2) within 1e-4,
    every decision equal (no variance lies within 1e-4 of threshold^2 on
    either side), the outputs within 1e-4 * max(|y|, 1) and the
    simulator's own outputs exactly."""
    jpost, tpost = quad_gp_noisy
    rng = np.random.default_rng(1)
    xs = np.concatenate([rng.uniform(-1.5, 1.5, (14, 2)),
                         rng.uniform(2.5, 3.5, (6, 2))]).astype(np.float32)
    rng.shuffle(xs)
    j, jlog = _stream(jcore, jadaptive, jpost, xs, backend, thr, monkeypatch)
    t, tlog = _stream(tcore, tadaptive, tpost, xs, backend, thr, monkeypatch)
    assert len(jlog) == len(tlog) == len(xs)
    var_j, var_t = np.square(jlog), np.square(tlog)
    assert np.abs(var_t - var_j).max() <= 1e-4
    assert np.minimum(np.abs(var_j - thr ** 2),
                      np.abs(var_t - thr ** 2)).min() > 1e-4
    np.testing.assert_array_equal(t.used_simulator, j.used_simulator)
    err = np.abs(t.outputs - j.outputs) / np.maximum(np.abs(j.outputs), 1.0)
    assert err.max() <= 1e-4, err.max()
    np.testing.assert_array_equal(t.outputs[t.used_simulator],
                                  j.outputs[j.used_simulator])
    assert t.n_sim_calls == j.n_sim_calls
    assert 0 < t.n_sim_calls < len(xs)


def test_port_adaptive_delegation_reduces_simulator_calls(quad_gp):
    """Twin of test_adaptive_delegation_reduces_simulator_calls."""
    _, post = quad_gp
    near = np.random.default_rng(0).uniform(-1.5, 1.5, (10, 2)) \
        .astype(np.float32)
    with tcore.Executor({"quad": _quad_factory(tcore)}, n_workers=2) as ex:
        res = tadaptive.evaluate_stream(ex, "quad", post, near,
                                        sd_threshold=0.25)
    assert res.n_sim_calls < len(near)
    want = np.stack([near[:, 0] ** 2 + near[:, 1],
                     near[:, 0] - near[:, 1] ** 2], 1)
    np.testing.assert_allclose(res.outputs, want, atol=0.35)
    np.testing.assert_allclose(res.outputs[res.used_simulator],
                               want[res.used_simulator], atol=1e-5)


def test_port_adaptive_conditioning_enriches_surrogate():
    """Twin of test_adaptive_conditioning_enriches_surrogate."""
    rng = np.random.default_rng(1)
    xs = rng.uniform(-0.5, 0.5, (15, 2)).astype(np.float32)
    ys = np.stack([xs[:, 0] ** 2 + xs[:, 1], xs[:, 0] - xs[:, 1] ** 2], 1)
    post = tgp.fit(xs, ys, steps=150)
    probe = np.array([[1.8, 1.8]], np.float32)
    _, var_before = tgp.predict(post, probe)
    with tcore.Executor({"quad": _quad_factory(tcore)}, n_workers=1) as ex:
        res = tadaptive.evaluate_stream(ex, "quad", post, probe,
                                        sd_threshold=0.01)
    assert res.n_sim_calls == 1
    _, var_after = tgp.predict(res.posterior, probe)
    assert torch.all(var_after[0] < var_before[0])


def test_adaptive_refuses_a_surrogate_off_the_device(quad_gp, monkeypatch):
    """With the default device (CUDA) and no card the stream raises; and
    a surrogate whose tensors lie on another device than the selected
    one is refused rather than run where it lies."""
    _, post = quad_gp
    xs = np.zeros((2, 2), np.float32)
    elsewhere = tgp.posterior_from_numpy(tgp.posterior_to_numpy(post),
                                         "meta")
    with tcore.Executor({"quad": _quad_factory(tcore)}, n_workers=1) as ex:
        with pytest.raises(RuntimeError, match="set_device"):
            tadaptive.evaluate_stream(ex, "quad", elsewhere, xs)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        device.set_device("cuda")
        try:
            with pytest.raises(RuntimeError, match="set_device"):
                tadaptive.evaluate_stream(ex, "quad", post, xs)
        finally:
            device.set_device("cpu")
