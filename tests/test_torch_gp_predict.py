"""The arithmetic of the port's batched GP predict kernels, on the CPU.

A predict call on the card is three kernels (`csrc/gp_kernel.cu`):
`gp_predict_k0` writes the unscaled correlation K0 over the training rows
padded to 32-row blocks and the queries padded to 64, and K0^T alpha
summed per row block; `gp_predict_tri` forms W = L^-1 K0 one row block at
a time from the 32-wide k-tiles up to the diagonal (the tiles above it
are skipped; the even and the odd ones summed apart, then added) and sums
W^2 over each row block; `gp_predict_reduce` adds the partials in
row-block order and scales by the variance and its square last.
`_gp_predict_emulation` does that arithmetic in f32 with torch and is
held to `repro.kernels.ref` and to the Pallas kernels in interpret mode,
on identical numpy inputs, at 2e-5: the reference's own tolerance for
these kernels (tests/test_kernels.py); both sides are f32 with the same
formulas and differ only in summation order.
"""
import numpy as np
import pytest
import torch

from repro.kernels import gp_kernel as pallas_gp
from repro.kernels import ref as jref
from repro_torch.kernels import gp_kernel
from repro_torch.kernels import ref as tref
from torch_port_util import on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

TOL = 2e-5


def _gp_predict_emulation(xt, xs, ls, var, alpha, linv, kind):
    """The three kernels' arithmetic for stacked operands [E, ...]."""
    e, n, _ = xt.shape
    s, m = xs.shape[1], alpha.shape[2]
    shapes = gp_kernel.predict_scratch(e, n, s, m)
    _, npad, spad = shapes["k0"]
    kt = gp_kernel.ROW_BLOCK
    # gp_predict_k0: K0 by the reference formula, zero in the padded rows
    k0 = torch.zeros(e, npad, spad)
    k0[:, :n, :s] = tref.gp_kernel_matrix(xt, xs, ls, torch.tensor(1.0),
                                          kind)
    al = torch.zeros(e, npad, m)
    al[:, :n] = alpha
    mpart = torch.stack([k0[:, j:j + kt].transpose(1, 2) @ al[:, j:j + kt]
                         for j in range(0, npad, kt)], 1)
    assert tuple(mpart.shape) == shapes["mpart"]
    # gp_predict_tri: each row block from its k-tiles up to the diagonal,
    # the even and the odd ones summed apart, then added
    lp = torch.zeros(e, npad, npad)
    lp[:, :n, :n] = linv
    qparts = []
    for r0 in range(0, npad, kt):
        w = [torch.zeros(e, kt, spad), torch.zeros(e, kt, spad)]
        for i, kc in enumerate(range(0, r0 + kt, kt)):
            w[i % 2] = w[i % 2] + lp[:, r0:r0 + kt, kc:kc + kt] \
                @ k0[:, kc:kc + kt]
        w = w[0] + w[1]
        qparts.append((w * w).sum(1))
    qpart = torch.stack(qparts, 1)
    assert tuple(qpart.shape) == shapes["qpart"]
    # gp_predict_reduce: partials in row-block order, the scaling last
    mean, qf = torch.zeros(e, spad, m), torch.zeros(e, spad)
    for rb in range(mpart.shape[1]):
        mean = mean + mpart[:, rb]
    for ib in range(qpart.shape[1]):
        qf = qf + qpart[:, ib]
    return var * mean[:, :s], (var * var) * qf[:, :s]


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


def _zero_pad_rows(xt, alpha, linv, expert, keep):
    """Expert `expert` keeps its first `keep` training rows; the rest are
    padding, as the partitioned engine stacks its experts."""
    xt[expert, keep:] = 0.0
    alpha[expert, keep:] = 0.0
    linv[expert, keep:, :] = 0.0
    linv[expert, :, keep:] = 0.0


# (e, n, s, d, m): n and S off the tiles (1, 33, 255, 257) and on them
# (64, 128), M = 1..4, d = 1, 2, 7, 16, and five experts with padding
CASES = [(1, 1, 1, 7, 1), (1, 33, 255, 7, 2), (1, 255, 33, 2, 3),
         (1, 257, 257, 16, 4), (1, 64, 128, 1, 1), (1, 128, 64, 7, 2),
         (1, 256, 1, 7, 2), (1, 1, 257, 2, 4), (5, 40, 70, 7, 2),
         (5, 33, 1, 16, 4), (5, 64, 65, 1, 3)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "e{}-n{}-s{}-d{}-m{}"
                         .format(*c))
@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_emulation_matches_reference_and_pallas(case, kind):
    e, n, s, d, m = case
    xt, xs, ls, var, alpha, linv = _predict_inputs(e, n, s, d, m)
    if e > 1:
        _zero_pad_rows(xt, alpha, linv, 2, n // 3)
        _zero_pad_rows(xt, alpha, linv, 4, 1)
    args = (xt, xs, ls, var, alpha, linv)
    mean, qf = _gp_predict_emulation(
        *(torch.as_tensor(np.asarray(a)) for a in args), kind)
    if e == 1:
        single = (xt[0], xs[0], ls, var, alpha[0], linv[0])
        wants = [jref.gp_predict(*single, kind),
                 pallas_gp.gp_predict(*single, kind, block_s=32,
                                      interpret=True)]
        wants = [(np.asarray(wm)[None], np.asarray(wq)[None])
                 for wm, wq in wants]
    else:
        wants = [jref.gp_predict_experts(*args, kind),
                 pallas_gp.gp_predict_experts(*args, kind, block_s=8,
                                              interpret=True)]
    for want_m, want_q in wants:
        np.testing.assert_allclose(mean.numpy(), np.asarray(want_m),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(qf.numpy(), np.asarray(want_q),
                                   atol=TOL, rtol=TOL)


def test_scratch_shapes():
    """K0 over the rows padded to 32 and the queries padded to 64; the
    mean's partials and the sums of squares per 32-row block."""
    assert gp_kernel.predict_scratch(1, 257, 1000, 4) == {
        "k0": (1, 288, 1024), "mpart": (1, 9, 1024, 4),
        "qpart": (1, 9, 1024)}
    assert gp_kernel.predict_scratch(64, 128, 1024, 1) == {
        "k0": (64, 128, 1024), "mpart": (64, 4, 1024, 1),
        "qpart": (64, 4, 1024)}
