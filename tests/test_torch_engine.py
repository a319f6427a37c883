"""`repro_torch.uq.engine` against `repro.uq.engine` on the same
conditioning stream.

Both packages start from one posterior (trained by the JAX package and
carried across with `posterior_from_numpy`) and absorb the same seeded
stream of batches.  Every conditioning re-factorises on each side with
its own f32 Cholesky (LAPACK here, XLA there), so predictions are pinned
per output column within 1e-3 of that column's range plus 5e-4 — the
pin `tests/test_surrogate_engine.py` uses between two backends of the
reference itself; it still catches any algorithmic drift.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.uq import engine as jengine
from repro.uq import gp as jgp
from repro_torch.uq import engine as tengine
from repro_torch.uq import gp as tgp
from torch_port_util import export_posterior, np32, on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")


def _target(x):
    return np.stack([np.sin(2.0 * x[:, 0]) + 0.5 * x[:, 1],
                     x[:, 0] - x[:, 1] ** 2], 1)


def _stream(n_batches, sizes=(1, 2, 3, 5), seed=0):
    """The conditioning stream of tests/test_surrogate_engine.py: batches
    drawn from the generator that drew the fixture's training inputs."""
    rng = np.random.default_rng(seed)
    rng.uniform(-2, 2, (30, 2))
    for b in range(n_batches):
        x = rng.uniform(-2, 2, (sizes[b % len(sizes)], 2)).astype(np.float32)
        yield x, _target(x).astype(np.float32)


PROBE = np.stack(np.meshgrid(np.linspace(-2, 2, 7), np.linspace(-2, 2, 7),
                             indexing="ij"), -1).reshape(-1, 2) \
    .astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """The reference's fitted posterior (tests/test_surrogate_engine.py's
    `_fitted_post()`): its fitted noise is tiny and K ill-conditioned."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (30, 2)).astype(np.float32)
    jpost = jgp.fit(x, _target(x).astype(np.float32), steps=120)
    return jpost, export_posterior(jpost)


@pytest.fixture(scope="module")
def conditioned(carried):
    """The fitted posterior with its noise raised to 0.03.  With the
    fitted noise K's condition number is ~1e6, and each conditioning's
    independent f32 factorisation on the two sides then drifts past any
    useful pin; at 0.03 the comparison measures the engines."""
    jpost, _ = carried
    params = jgp.GPParams(jpost.params.log_lengthscale,
                          jpost.params.log_variance,
                          jnp.log(jnp.float32(0.03)))
    base = dataclasses.replace(jpost, params=params)
    jpost = jgp.recondition(base, jpost.x, jpost.y)
    return jpost, export_posterior(jpost)


def _close_scaled(got, want, tol=1e-3):
    got, want = np32(got), np32(want)
    scale = want.max(axis=0) - want.min(axis=0)
    err = np.abs(got - want).max(axis=0)
    assert (err <= 5e-4 + tol * np.maximum(scale, 1.0)).all(), \
        f"err={err} vs scale={scale}"


@pytest.mark.parametrize("backend,kw,n_batches", [
    ("exact", {}, 6), ("exact", {"max_points": 36}, 6),
    ("incremental", {}, 6), ("incremental", {"refactor_every": 3}, 6),
    # every reference expert refactor compiles anew: few, wide batches
    ("partitioned", {"expert_cap": 16}, 2),
])
def test_engine_matches_reference_over_stream(conditioned, backend, kw,
                                              n_batches):
    jpost, d = conditioned
    jeng = jengine.wrap_posterior(jpost, backend, **kw)
    teng = tengine.wrap_posterior(tgp.posterior_from_numpy(d, "cpu"),
                                  backend, **kw)
    for x, y in _stream(n_batches,
                        sizes=(5, 7) if backend == "partitioned"
                        else (1, 2, 3, 5)):
        jeng = jeng.condition(x, y)
        teng = teng.condition(x, y)
        assert teng.n_train() == jeng.n_train()
        jm, jv = jeng.predict_batch(PROBE)
        tm, tv = teng.predict_batch(PROBE)
        _close_scaled(tm, jm)
        _close_scaled(tv, jv)
    if backend != "exact":
        assert teng.stats == jeng.stats
    if backend == "partitioned":
        assert all(int(e.x.shape[0]) <= 16 for e in teng.experts)
        assert len(teng.experts) == len(jeng.experts)
        for te, je in zip(teng.experts, jeng.experts):
            np.testing.assert_array_equal(np32(te.x), np32(je.x))


def test_incremental_matches_port_exact(carried):
    """Within the port: rank-k block updates against full refactors."""
    _, d = carried
    exact = tengine.wrap_posterior(tgp.posterior_from_numpy(d, "cpu"))
    inc = tengine.wrap_posterior(tgp.posterior_from_numpy(d, "cpu"),
                                 "incremental")
    for x, y in _stream(16):
        exact = exact.condition(x, y)
        inc = inc.condition(x, y)
        _close_scaled(inc.predict_batch(PROBE)[0],
                      exact.predict_batch(PROBE)[0])
    assert inc.stats["block_updates"] >= 14
    # the maintained inverse still inverts the extended factor
    post = inc.post
    eye = post.linv @ post.chol
    np.testing.assert_allclose(np32(eye), np.eye(eye.shape[0]), atol=2e-3)
    assert torch.equal(torch.triu(post.linv, 1),
                       torch.zeros_like(post.linv))


def _f64_mean(d, xq):
    """The exact GP mean in float64 under the posterior's hyperparameters
    and standardisation (RBF)."""
    p = {k: np.float64(v) for k, v in d["params"].items()}
    ls = np.exp(np.clip(p["ls"], -5, 5))
    var = np.exp(np.clip(p["var"], -8, 8))
    s2 = np.exp(2 * np.clip(p["noise"], -5, 5))

    def k(a, b):
        return var * np.exp(-0.5 * (((a[:, None] - b[None]) / ls) ** 2)
                            .sum(-1))

    x = d["x"].astype(np.float64)
    ym, ys = d["y_mean"].astype(np.float64), d["y_std"].astype(np.float64)
    kxx = k(x, x) + (s2 + 1e-5 * (var + 1)) * np.eye(len(x))
    alpha = np.linalg.solve(kxx, (d["y"] - ym) / ys)
    return ym + k(xq.astype(np.float64), x) @ alpha * ys


def test_partitioned_single_expert_pinned_to_both_exact(carried):
    """One expert holding everything is an exact GP under the fit-time
    standardisation.  The reference's own check of this
    (test_partitioned_single_expert_is_exact) fails on this tree, so here
    the port's one-expert engine is held against BOTH exact engines.

    Against the port's exact engine re-factorised from the same data (one
    factorisation code path) it holds at the reference's tolerance.  The
    carried posterior's fitted noise is tiny (cond(K) ~ 1e6), so two
    independent f32 factorisations of K land ~1e-3 apart: the reference's
    exact engine reuses the factor of its jitted fit while its one-expert
    engine re-factorises eagerly, which is its failure.  Against the
    exact engines on that carried factor, and against the float64 GP,
    every engine is held at the cross-package pin — no side is wrong; the
    f32 rounding of an ill-conditioned factor is what moves."""
    jpost, d = carried
    post = tgp.posterior_from_numpy(d, "cpu")
    part = tengine.wrap_posterior(post, "partitioned", expert_cap=1000)
    assert len(part.experts) == 1
    mp, vp = part.predict_batch(PROBE)
    refit = tengine.wrap_posterior(tgp.recondition(post, post.x, post.y))
    me, ve = refit.predict_batch(PROBE)
    np.testing.assert_allclose(np32(mp), np32(me), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(np32(vp), np32(ve), atol=2e-4, rtol=1e-3)
    truth = _f64_mean(d, PROBE)
    _close_scaled(mp, truth)
    for eng in (tengine.wrap_posterior(post), jengine.wrap_posterior(jpost)):
        me, ve = eng.predict_batch(PROBE)
        _close_scaled(mp, me)
        _close_scaled(vp, ve)
        _close_scaled(me, truth)


def test_partitioned_condition_is_persistent(carried):
    _, d = carried
    part = tengine.wrap_posterior(tgp.posterior_from_numpy(d, "cpu"),
                                  "partitioned", expert_cap=16)
    before = part.predict_batch(PROBE)
    x, y = next(_stream(1, sizes=(9,)))
    newer = part.condition(x, y)
    assert newer.n_train() == part.n_train() + 9
    after = part.predict_batch(PROBE)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["exact", "incremental", "partitioned"])
def test_fit_engine_and_protocol(backend):
    rng = np.random.default_rng(8)
    x = rng.uniform(-2, 2, (40, 2)).astype(np.float32)
    eng = tengine.fit_engine(x, _target(x), backend, steps=30,
                             **({"expert_cap": 16}
                                if backend == "partitioned" else {}))
    assert isinstance(eng, tengine.SurrogateEngine)
    assert eng.backend == backend
    assert (eng.n_train(), eng.dim(), eng.n_outputs()) == (40, 2, 2)
    assert tengine.as_engine(eng) is eng and tengine.as_engine(None) is None
    sd = eng.latent_sd(PROBE)
    assert sd.shape == (len(PROBE),) and np.isfinite(sd).all()
    with pytest.raises(ValueError):
        tengine.wrap_posterior(getattr(eng, "post", None), "nope")


def test_partitioned_bucket_accounting(carried):
    _, d = carried
    part = tengine.wrap_posterior(tgp.posterior_from_numpy(d, "cpu"),
                                  "partitioned", expert_cap=8)
    before = dict(tgp.predict_batch_shapes)
    part.predict_batch(np.random.default_rng(1).uniform(-2, 2, (3000, 2)))
    new = {k: v - before.get(k, 0) for k, v in
           tgp.predict_batch_shapes.items() if v != before.get(k, 0)}
    assert new and all(k[0] == "part" and k[1] == len(part.experts)
                       and k[3] in tgp.PREDICT_BUCKETS for k in new)
