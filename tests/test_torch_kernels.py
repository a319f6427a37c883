"""The port's GP kernels against the JAX reference, on the CPU.

The plain PyTorch versions (`repro_torch.kernels.ref`, what the
dispatcher runs for CPU tensors) against `repro.kernels.ref` and the
Pallas kernels in interpret mode, on identical numpy inputs, at 2e-5 —
the reference's own tolerance for these kernels (tests/test_kernels.py):
both sides are f32 with the same formulas and differ only in summation
order.  The CUDA kernels themselves are held against these plain versions
on the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from repro.kernels import gp_kernel as pallas_gp
from repro.kernels import ref as jref
from repro_torch.kernels import gp_kernel, ops
from repro_torch.kernels import ref as tref
from torch_port_util import on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

TOL = 2e-5


def _inputs(n, m, d, seed=8):
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((n, d)).astype(np.float32)
    x2 = rng.standard_normal((m, d)).astype(np.float32)
    ls = np.exp(rng.standard_normal(d) * 0.2).astype(np.float32)
    return x1, x2, ls, np.float32(1.7)


def _predict_inputs(e, n, s, d, m_out, seed=3):
    """Stacked operands with a real lower-triangular L^-1 per expert."""
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((e, n, d)).astype(np.float32)
    xs = rng.standard_normal((e, s, d)).astype(np.float32)
    ls = (2.0 * np.exp(rng.standard_normal(d) * 0.2)).astype(np.float32)
    var = np.float32(1.3)
    alpha = rng.standard_normal((e, n, m_out)).astype(np.float32)
    linv = np.zeros((e, n, n), np.float32)
    for i in range(e):
        k = np.asarray(jref.gp_kernel_matrix(xt[i], xt[i], ls, var))
        chol = np.linalg.cholesky(k.astype(np.float64) + 1e-2 * np.eye(n))
        linv[i] = np.linalg.inv(chol).astype(np.float32)
        linv[i][np.triu_indices(n, 1)] = 0.0
    return xt, xs, ls, var, alpha, linv


def _t(*arrs, dev="cpu"):
    return [torch.as_tensor(np.asarray(a), device=dev) for a in arrs]


@pytest.mark.parametrize("n,m,d", [(100, 57, 7), (33, 33, 3), (8, 300, 2)])
@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_kernel_matrix_matches_reference_and_pallas(n, m, d, kind):
    x1, x2, ls, var = _inputs(n, m, d)
    got = tref.gp_kernel_matrix(*_t(x1, x2, ls, var), kind).numpy()
    want = np.asarray(jref.gp_kernel_matrix(x1, x2, ls, var, kind))
    pallas = np.asarray(pallas_gp.gp_kernel_matrix(
        x1, x2, ls, var, kind, block_n=32, block_m=32, interpret=True))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n,s,m_out", [(37, 70, 2), (64, 9, 1)])
@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_predict_matches_reference_and_pallas(n, s, m_out, kind):
    xt, xs, ls, var, alpha, linv = _predict_inputs(1, n, s, 7, m_out)
    args = (xt[0], xs[0], ls, var, alpha[0], linv[0])
    mean, qf = tref.gp_predict(*_t(*args), kind)
    jm, jq = jref.gp_predict(*args, kind)
    pm, pq = pallas_gp.gp_predict(*args, kind, block_s=32, interpret=True)
    for want_m, want_q in ((jm, jq), (pm, pq)):
        np.testing.assert_allclose(mean.numpy(), np.asarray(want_m),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(qf.numpy(), np.asarray(want_q),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_predict_experts_matches_reference_and_pallas(kind):
    xt, xs, ls, var, alpha, linv = _predict_inputs(3, 20, 11, 7, 1)
    # a zero-padded expert: rows past 13 are padding, exact by construction
    xt[2, 13:] = 0.0
    alpha[2, 13:] = 0.0
    linv[2, 13:, :] = 0.0
    linv[2, :, 13:] = 0.0
    args = (xt, xs, ls, var, alpha, linv)
    mean, qf = tref.gp_predict_experts(*_t(*args), kind)
    jm, jq = jref.gp_predict_experts(*args, kind)
    pm, pq = pallas_gp.gp_predict_experts(*args, kind, block_s=8,
                                          interpret=True)
    for want_m, want_q in ((jm, jq), (pm, pq)):
        np.testing.assert_allclose(mean.numpy(), np.asarray(want_m),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(qf.numpy(), np.asarray(want_q),
                                   atol=TOL, rtol=TOL)


def test_dispatcher_takes_plain_version_on_cpu():
    """CPU tensors go to `ref`, bit for bit, and launch nothing."""
    x1, x2, ls, var = _inputs(19, 23, 7)
    xt, xs, pls, pvar, alpha, linv = _predict_inputs(2, 16, 5, 7, 2)
    before = dict(gp_kernel.launches)
    a = ops.gp_kernel_matrix(*_t(x1, x2, ls, var))
    assert torch.equal(a, tref.gp_kernel_matrix(*_t(x1, x2, ls, var)))
    p_args = _t(xt[0], xs[0], pls, pvar, alpha[0], linv[0])
    for got, want in zip(ops.gp_predict(*p_args), tref.gp_predict(*p_args)):
        assert torch.equal(got, want)
    e_args = _t(xt, xs, pls, pvar, alpha, linv)
    for got, want in zip(ops.gp_predict_experts(*e_args),
                         tref.gp_predict_experts(*e_args)):
        assert torch.equal(got, want)
    assert gp_kernel.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches on CUDA tensors or raises — it never computes
    on the CPU itself (and never builds anything to find out)."""
    x1, x2, ls, var = _inputs(4, 5, 3)
    with pytest.raises(ValueError, match="CUDA"):
        gp_kernel.gp_kernel_matrix(*_t(x1, x2, ls, var))
    xt, xs, pls, pvar, alpha, linv = _predict_inputs(1, 6, 3, 7, 1)
    with pytest.raises(ValueError, match="CUDA"):
        gp_kernel.gp_predict(*_t(xt[0], xs[0], pls, pvar, alpha[0],
                                 linv[0]))
    with pytest.raises(ValueError, match="CUDA"):
        gp_kernel.gp_predict_experts(*_t(xt, xs, pls, pvar, alpha, linv))
