"""`repro_torch.uq.gp` against `repro.uq.gp` on identical inputs.

A posterior trained by the JAX package is carried across with
`posterior_from_numpy`, so both packages compute on the same numbers.
Predictions are held at 1e-4: the two sides take the same f32 formulas
through different BLAS/LAPACK kernels (summation order), and the
variance is a difference of O(1) terms.  Fit is compared at the NLML
level only: LAPACK and XLA round an f32 Cholesky differently, so 200
Adam steps need not land on the same hyperparameters.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.uq import gp as jgp
from repro_torch import device
from repro_torch.obs import Tracer
from repro_torch.uq import gp as tgp
from torch_port_util import export_posterior, np32, on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

TOL = 1e-4


def _data(n=30, d=3, m=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d)).astype(np.float32)
    y = np.stack([np.sin(x[:, 0]) + 0.3 * x[:, 1],
                  2.0 + 5.0 * np.cos(x[:, 1]) - x[:, 2]], 1)[:, :m]
    return x, (y + 0.05 * rng.standard_normal(y.shape)).astype(np.float32)


@pytest.fixture(scope="module", params=["rbf", "matern52"])
def carried(request):
    """(jax posterior, port posterior on the CPU, query points)."""
    x, y = _data()
    jpost = jgp.fit(x, y, kind=request.param, steps=60)
    tpost = tgp.posterior_from_numpy(export_posterior(jpost), "cpu")
    xq = np.random.default_rng(5).uniform(-2.5, 2.5, (300, 3)) \
        .astype(np.float32)
    return jpost, tpost, xq


def test_predict_matches_reference(carried):
    jpost, tpost, xq = carried
    jm, jv = jgp.predict(jpost, xq)
    tm, tv = tgp.predict(tpost, xq)
    np.testing.assert_allclose(np32(tm), np32(jm), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(np32(tv), np32(jv), atol=TOL, rtol=TOL)


def test_predict_batch_matches_reference(carried):
    """The fused path at one row, a partial bucket and a full batch."""
    jpost, tpost, xq = carried
    for rows in (xq[:1], xq[:70], xq):
        jm, jv = jgp.predict_batch(jpost, rows)
        tm, tv = tgp.predict_batch(tpost, rows)
        assert tuple(tm.shape) == jm.shape and tuple(tv.shape) == jv.shape
        np.testing.assert_allclose(np32(tm), np32(jm), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(np32(tv), np32(jv), atol=TOL, rtol=TOL)


def test_nlml_matches_reference(carried):
    """1e-4 relative to the NLML's largest term, m*n*log(2*pi)/2: the
    NLML is a near-cancelling sum of the data fit, the log-determinant
    and that constant, so its own value is no scale for rounding."""
    jpost, tpost, _ = carried
    x, y = np32(jpost.x), np32(jpost.y)
    yn = (y - y.mean(0)) / np.maximum(y.std(0), 1e-8)
    j = float(jgp.nlml(jpost.params.tree(), jnp.asarray(x), jnp.asarray(yn),
                       jpost.kind))
    t = float(tgp.nlml(tpost.params.tree(), torch.tensor(x),
                       torch.tensor(yn), tpost.kind))
    scale = 0.5 * x.shape[0] * y.shape[1] * np.log(2 * np.pi)
    assert abs(t - j) <= TOL * max(abs(j), scale)


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_fit_reaches_reference_nlml(kind):
    """Both fits from the same init land at NLMLs within 1% (each
    evaluated by the JAX reference), far below the NLML at the init."""
    x, y = _data(n=24, seed=2)
    jpost = jgp.fit(x, y, kind=kind, steps=80)
    tpost = tgp.fit(x, y, kind=kind, steps=80)
    yn = jnp.asarray((y - y.mean(0)) / np.maximum(y.std(0), 1e-8))

    def jnlml(tree):
        return float(jgp.nlml({k: jnp.asarray(np32(v))
                               for k, v in tree.items()},
                              jnp.asarray(x), yn, kind))

    at_init = jnlml(jgp.GPParams.init(3).tree())
    j, t = jnlml(jpost.params.tree()), jnlml(tpost.params.tree())
    assert j < at_init and t < at_init
    assert abs(t - j) <= 0.01 * abs(at_init - j) + 1e-3 * abs(j)


def test_fit_survives_nan_gradients():
    """Duplicate inputs with zero noise floor drive the Cholesky to
    breakdown; NaN gradients are zeroed and the clips hold."""
    x = np.zeros((12, 2), np.float32)
    y = np.arange(12, dtype=np.float32)
    post = tgp.fit(x, y, steps=20)
    for k, v in post.params.tree().items():
        assert torch.isfinite(v).all(), k
    assert float(post.params.log_noise) <= 2.0


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_recondition_and_condition_match_reference(kind):
    """Each side rebuilds its own Cholesky here, so the posterior uses the
    initial hyperparameters (noise 0.1): with a fitted near-zero noise
    K's condition number alone amplifies f32 rounding past 1e-4."""
    x, y = _data()
    base = jgp.GPPosterior(params=jgp.GPParams.init(3), x=None, y=None,
                           y_mean=None, y_std=None, chol=None, alpha=None,
                           kind=kind)
    jpost = jgp.recondition(base, x, y)
    tpost = tgp.posterior_from_numpy(export_posterior(jpost), "cpu")
    rng = np.random.default_rng(7)
    x_new = rng.uniform(-2, 2, (6, 3)).astype(np.float32)
    y_new = rng.standard_normal((6, 2)).astype(np.float32)
    xq = rng.uniform(-2.5, 2.5, (50, 3)).astype(np.float32)
    j2 = jgp.condition(jpost, x_new, y_new)
    t2 = tgp.condition(tpost, x_new, y_new)
    assert tuple(t2.x.shape) == j2.x.shape
    for a, b in ((t2.chol, j2.chol), (t2.alpha, j2.alpha),
                 (t2.y_std, j2.y_std)):
        np.testing.assert_allclose(np32(a), np32(b), atol=TOL, rtol=TOL)
    tm, tv = tgp.predict_batch(t2, xq)
    jm, jv = jgp.predict_batch(j2, xq)
    np.testing.assert_allclose(np32(tm), np32(jm), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(np32(tv), np32(jv), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("x_new,y_new,want", [
    (np.zeros(3), np.array([1.0, 2.0]), ((1, 3), (1, 2))),
    (np.zeros((4, 3)), np.arange(4.0), ((4, 3), (4, 1))),
    (np.zeros((2, 3)), np.ones((2, 2)), ((2, 3), (2, 2))),
])
def test_coerce_new_data_shapes(x_new, y_new, want):
    tx, ty = tgp.coerce_new_data(x_new, y_new)
    jx, jy = jgp.coerce_new_data(x_new, y_new)
    assert (tuple(tx.shape), tuple(ty.shape)) == want == (jx.shape, jy.shape)
    assert tx.dtype == ty.dtype == torch.float32


def test_linv_cache_lifecycle(carried):
    _, tpost, xq = carried
    post = tgp.posterior_from_numpy(tgp.posterior_to_numpy(tpost), "cpu")
    assert post.linv is None
    linv = tgp.ensure_linv(post)
    assert tgp.ensure_linv(post) is linv
    assert torch.equal(torch.triu(linv, 1), torch.zeros_like(linv))
    assert linv.is_contiguous()
    tgp.invalidate_linv(post)
    assert post.linv is None
    m1, _ = tgp.predict_batch(post, xq[:5])
    m2, _ = tgp.predict(post, xq[:5])
    np.testing.assert_allclose(np32(m1), np32(m2), atol=TOL, rtol=TOL)


def test_bucket_counters_and_tracer(carried):
    """Launch accounting matches `repro`'s bucket plan, and each launch
    emits one `gp.predict_batch` instant."""
    _, tpost, _ = carried
    assert tgp.PREDICT_BUCKETS == jgp.PREDICT_BUCKETS
    for s in (0, 1, 64, 65, 1024, 1025, 2500):
        assert tgp.bucket_launches(s) == jgp.bucket_launches(s)
    with pytest.raises(ValueError):
        tgp.bucket_of(tgp.PREDICT_BUCKETS[-1] + 1)
    xq = np.zeros((2500, 3), np.float32)
    before = dict(tgp.predict_batch_shapes)
    tracer = Tracer()
    tgp.set_obs_tracer(tracer)
    try:
        mean, var = tgp.predict_batch(tpost, xq)
    finally:
        tgp.set_obs_tracer(None)
    assert tuple(mean.shape) == (2500, 2) == tuple(var.shape)
    n = int(tpost.x.shape[0])
    new = {k: v - before.get(k, 0) for k, v in
           tgp.predict_batch_shapes.items() if v != before.get(k, 0)}
    want = {}
    for b in tgp.bucket_launches(2500):
        want[(n, b)] = want.get((n, b), 0) + 1
    assert new == want
    instants = [e for e in tracer.events() if e[2] == "gp.predict_batch"]
    assert len(instants) == 3


def test_posterior_roundtrip(carried):
    _, tpost, _ = carried
    back = tgp.posterior_from_numpy(tgp.posterior_to_numpy(tpost), "cpu")
    for a, b in ((back.x, tpost.x), (back.chol, tpost.chol),
                 (back.alpha, tpost.alpha),
                 (back.params.log_lengthscale,
                  tpost.params.log_lengthscale)):
        assert torch.equal(a, b)
    assert back.kind == tpost.kind


def test_params_init_takes_the_package_device():
    """`GPParams.init(d)` with no device, as code written against
    `repro.uq.gp` calls it (tests/test_offload.py builds its analytic
    posterior so): on the CPU default it is the reference's initial tree,
    and an explicit device still wins."""
    want = jgp.GPParams.init(3).tree()
    for params in (tgp.GPParams.init(3),
                   tgp.GPParams.init(3, torch.device("cpu"))):
        got = params.tree()
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(np32(got[k]), np.asarray(v))


def test_params_init_without_a_card_raises(monkeypatch):
    """Under the default device (CUDA) with no card, `GPParams.init(d)`
    raises, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    device.set_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="set_device"):
            tgp.GPParams.init(3)
    finally:
        device.set_device("cpu")
