"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the GP path on the card against the port on the CPU.

Every test here is marked `gpu` and skips without a CUDA card.  The file
imports only torch and `repro_torch`, so it runs where JAX is absent:

    python -m pytest -m gpu tests/test_torch_cuda.py

Tolerances: 2e-5 for the covariance matrix (same f32 formula, summation
order of a D-term dot product), 1e-4 for the predict's mean and quadratic
form (sums over the n training rows, accumulated in another order than
the plain version's BLAS).
"""
import numpy as np
import pytest
import torch

from repro_torch import device
from repro_torch.kernels import gp_kernel
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device.set_device("cuda")
    return torch.device("cuda")


def _inputs(n, m, d, dev, seed=8):
    g = torch.Generator().manual_seed(seed)
    x1 = torch.randn(n, d, generator=g)
    x2 = torch.randn(m, d, generator=g)
    ls = torch.exp(0.2 * torch.randn(d, generator=g))
    return [t.to(dev) for t in (x1, x2, ls, torch.tensor(1.7))]


def _predict_inputs(e, n, s, m_out, dev, seed=3):
    g = torch.Generator().manual_seed(seed)
    xt = torch.randn(e, n, 7, generator=g)
    xs = torch.randn(e, s, 7, generator=g)
    ls = 2.0 * torch.exp(0.2 * torch.randn(7, generator=g))
    var = torch.tensor(1.3)
    alpha = torch.randn(e, n, m_out, generator=g)
    k = ref.gp_kernel_matrix(xt, xt, ls, var) + 1e-2 * torch.eye(n)
    eye = torch.eye(n).expand(e, n, n)
    linv = torch.linalg.solve_triangular(torch.linalg.cholesky(k), eye,
                                         upper=False)
    return [t.contiguous().to(dev) for t in (xt, xs, ls, var, alpha, linv)]


@pytest.mark.parametrize("n,m,d", [(100, 57, 7), (33, 33, 3), (8, 300, 2),
                                   (2048, 2048, 7)])
@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_kernel_matrix_matches_plain(cuda, n, m, d, kind):
    args = _inputs(n, m, d, cuda)
    before = gp_kernel.launches["gp_kernel_matrix"]
    got = gp_kernel.gp_kernel_matrix(*args, kind)
    torch.cuda.synchronize()
    assert gp_kernel.launches["gp_kernel_matrix"] == before + 1
    torch.testing.assert_close(got, ref.gp_kernel_matrix(*args, kind),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("e,n,s,m_out", [(1, 37, 70, 2), (1, 256, 1024, 2),
                                         (1, 300, 33, 1), (5, 128, 64, 1)])
@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_predict_matches_plain(cuda, e, n, s, m_out, kind):
    args = _predict_inputs(e, n, s, m_out, cuda)
    if e == 1:
        single = [a[0] if a.dim() == 3 else a for a in args]
        got = [g[None] for g in gp_kernel.gp_predict(*single, kind)]
    else:
        got = gp_kernel.gp_predict_experts(*args, kind)
    torch.cuda.synchronize()
    for g, w in zip(got, ref.gp_predict_experts(*args, kind)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_kernel_matrix_gradient_matches_plain(cuda):
    x1, x2, ls, var = _inputs(40, 30, 7, cuda)
    grads = []
    for fn in (gp_kernel.gp_kernel_matrix, ref.gp_kernel_matrix):
        ls_ = ls.clone().requires_grad_()
        var_ = var.clone().requires_grad_()
        fn(x1, x2, ls_, var_, "matern52").square().sum().backward()
        grads.append((ls_.grad, var_.grad))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_wrapper_rejects_bad_operands(cuda):
    x1, x2, ls, var = _inputs(10, 12, 3, cuda)
    with pytest.raises(ValueError, match="float32"):
        gp_kernel.gp_kernel_matrix(x1.double(), x2, ls, var)
    with pytest.raises(ValueError, match="contiguous"):
        gp_kernel.gp_kernel_matrix(x1.T.contiguous().T, x2, ls, var)
    with pytest.raises(ValueError, match="dimension"):
        wide = torch.zeros(4, 17, device=cuda)
        gp_kernel.gp_kernel_matrix(wide, wide, torch.ones(17, device=cuda),
                                   var)


def test_gp_path_on_card_matches_port_on_cpu(cuda):
    """Fit on the card, carry the posterior to the CPU: the batched
    predict and the engines agree at 1e-4."""
    from repro_torch.uq import engine, gp
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    y = np.stack([np.sin(x[:, 0]), x[:, 1] * x[:, 2]], 1)
    post = gp.fit(x, y, steps=40)
    assert post.x.device.type == "cuda"
    cpu = gp.posterior_from_numpy(gp.posterior_to_numpy(post), "cpu")
    xq = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    for a, b in zip(gp.predict_batch(post, xq), gp.predict_batch(cpu, xq)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    part = engine.wrap_posterior(post, "partitioned", expert_cap=16)
    part_cpu = engine.wrap_posterior(cpu, "partitioned", expert_cap=16)
    for a, b in zip(part.predict_batch(xq), part_cpu.predict_batch(xq)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=1e-3)
