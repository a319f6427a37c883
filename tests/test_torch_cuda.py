"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the GP and LM paths on the card against the port on the CPU.

Every test here is marked `gpu` and skips without a CUDA card.  The file
imports only torch and `repro_torch`, so it runs where JAX is absent:

    python -m pytest -m gpu tests/test_torch_cuda.py

Tolerances: 2e-5 for the covariance matrix (same f32 formula, summation
order of a D-term dot product).  Its gradient in the hyperparameters,
relative to each component's sum of absolute terms (`scale`, the plain
closed form on |G|): 1e-5 * scale against the plain closed form (the same
f32 terms, summed in another order), 1e-4 * scale against the autograd of
the plain matrix (which differentiates the expanded d2;
tests/test_torch_gp_kernel_grad.py holds the kernel's summation order to
both on the CPU).  A 40-step fit, card against CPU: final NLML and
log-parameters within 1e-3 + 1e-3 |x| (Adam steps amplify rounding).
1e-4 for the predict's mean and quadratic
form (sums over the n training rows, accumulated in another order than
the plain version's BLAS).  Attention: 2e-5 in f32 (a Dh-term dot
product and a softmax summed in another order), 2e-2 in bf16: both round
an f32 result to bf16 (a step of at most 2^-6 below 4), and the kernel
also rounds each probability to bf16 before the P V product on the
tensor cores (at most 2^-9 relative each; tests/test_torch_lm_kernels.py
holds a plain emulation of that arithmetic to the reference on the CPU).
SSD: 2e-3
absolute and relative in f32 (the reference's own tolerance: chunked sums
in another order), 2e-2 in bf16 (both round an f32 y to bf16 once).  SSD
backward, against its plain version (`ref.mamba2_ssd_bwd`, the same
chunked algorithm): each gradient within 1e-4 of its max|g| (f32 sums in
another order), plus 2^-8 max|g| for a gradient in bf16 (both round the
f32 result once); under a strong decay against autograd of the
sequential recurrence in f64 at the same limits.  WKV backward, against
`ref.rwkv6_wkv_bwd`, the same limits, dw compared as w o dw.
WKV: 2e-4 in f32 (the reference's own tolerance, tests/test_kernels.py:
the kernel's exponentials are exp2 of log2 sums, and its sums run in
another order); in bf16 out within 2e-2 + 2e-2 |y| (both round an f32
result to bf16 once) and the f32 state within 2e-3 + 2e-3 |s|.
Reduced models, card against CPU: 1e-3 relative to max(|x|, 1) (f32
matmuls and the kernels sum in other orders than the CPU's, through a few
layers).  An MoE layer, card against CPU with the same routing: 1e-5 in
f32, 1e-2 in bf16 (a sum that lands on the other side of a bf16 rounding
boundary moves a result by one bf16 step); in bf16 two calls on the card
give the same bits.  The MoE layer's bf16 backward (the f32-result
products' Function, the fixed-order dispatch): the same bits over two
calls, each gradient within 2e-2 relative L2 of the CPU's.  AdamW sliced
and whole: the same bits.
"""
import numpy as np
import pytest
import torch

from repro_torch import device
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import gp_kernel
from repro_torch.kernels import mamba2_ssd as ssd_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_wkv as wkv_kernel

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device.set_device("cuda")
    device.strict_numerics()
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
                                   (2048, 2048, 7), (70, 45, 1),
                                   (50, 129, 16), (256, 256, 7)])
@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_kernel_matrix_matches_plain(cuda, n, m, d, kind):
    args = _inputs(n, m, d, cuda)
    before = gp_kernel.launches["gp_kernel_matrix"]
    got = gp_kernel.gp_kernel_matrix(*args, kind)
    torch.cuda.synchronize()
    assert gp_kernel.launches["gp_kernel_matrix"] == before + 1
    torch.testing.assert_close(got, ref.gp_kernel_matrix(*args, kind),
                               atol=2e-5, rtol=2e-5)


def _zero_pad_experts(args, keep):
    """Every other expert keeps its first `keep` training rows; the rest
    are padding (zero inputs, alpha, and rows and columns of L^-1), as the
    partitioned engine stacks its experts."""
    xt, _, _, _, alpha, linv = args
    for t in (xt[1::2, keep:], alpha[1::2, keep:], linv[1::2, keep:],
              linv[1::2, :, keep:]):
        t.zero_()


@pytest.mark.parametrize("e,n,s,m_out,padded", [
    (1, 37, 70, 2, False), (1, 256, 1024, 2, False), (1, 300, 33, 1, False),
    (5, 128, 64, 1, False), (1, 2048, 1024, 2, False),
    (64, 128, 1024, 1, True), (1, 257, 1000, 4, False), (1, 1, 1, 1, False)])
@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_predict_matches_plain(cuda, e, n, s, m_out, padded, kind):
    args = _predict_inputs(e, n, s, m_out, cuda)
    if padded:
        _zero_pad_experts(args, n // 3)
    if e == 1:
        single = [a[0] if a.dim() == 3 else a for a in args]
        got = [g[None] for g in gp_kernel.gp_predict(*single, kind)]
    else:
        got = gp_kernel.gp_predict_experts(*args, kind)
    torch.cuda.synchronize()
    for g, w in zip(got, ref.gp_predict_experts(*args, kind)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def _device_kernel_counts(fn, calls, per_call=3):
    """Kernel name -> launches in one profiler window of `calls` calls of
    `fn` (`per_call` kernels each), opened with one untimed call.  The
    profiler now and then drops a launch from a window, so a window short
    of `per_call` x `calls` launches is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
        counts = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}
        if sum(counts.values()) >= per_call * calls:
            break
    return counts


@pytest.mark.parametrize("e,n,s", [(1, 256, 1024), (64, 128, 1024)])
def test_predict_launches_three_kernels_per_call(cuda, e, n, s):
    """One predict call is its three kernels and nothing else on the
    device (no eager scaling after them)."""
    args = _predict_inputs(e, n, s, 2, cuda)
    if e == 1:
        args = [a[0] if a.dim() == 3 else a for a in args]
        fn = (lambda: gp_kernel.gp_predict(*args))
    else:
        fn = (lambda: gp_kernel.gp_predict_experts(*args))
    calls = 4
    counts = _device_kernel_counts(fn, calls)
    assert len(counts) == 3 and sum(counts.values()) == 3 * calls, counts
    for phase in ("gp_predict_k0", "gp_predict_tri", "gp_predict_reduce"):
        assert [c for k, c in counts.items() if phase in k] == [calls], counts


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


def _grad_case(n, m, d, same, dev, seed=4):
    """x1, x2 (x1 itself where `same`), ls, var and an upstream gradient of
    both signs, on `dev`."""
    g = torch.Generator().manual_seed(seed)
    x1 = torch.randn(n, d, generator=g)
    x2 = x1 if same else torch.randn(m, d, generator=g)
    ls = torch.exp(0.2 * torch.randn(d, generator=g) + 0.5)
    up = torch.randn(n, x2.shape[0], generator=g)
    return [t.to(dev) for t in (up, x1, x2, ls, torch.tensor(1.7))]


def _assert_grad_within(got, want, scale, tol):
    for a, b, s in zip(got, want, scale):
        assert a.shape == b.shape and a.dtype == torch.float32
        err = (a.double() - b.double()).abs()
        assert bool((err <= tol * s).all()), float((err / s).max())


@pytest.mark.parametrize("n,m,same,column_major", [
    (40, 30, False, False), (256, 256, True, False),
    (2048, 2048, True, False), (70, 300, False, True)])
@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_kernel_matrix_grad_matches_plain(cuda, n, m, same, column_major,
                                          kind):
    """The gradient kernel against its plain closed form and, off the
    diagonal, the plain matrix's autograd; a column-major upstream
    gradient goes in transposed with the points swapped."""
    up, x1, x2, ls, var = _grad_case(n, m, 7, same, cuda)
    if column_major:
        up = up.T.contiguous().T
    before = gp_kernel.launches["gp_kernel_matrix_grad"]
    got = gp_kernel.gp_kernel_matrix_grad(up, x1, x2, ls, var, kind)
    torch.cuda.synchronize()
    assert gp_kernel.launches["gp_kernel_matrix_grad"] == before + 1
    scale = [t.double() for t in ref.gp_kernel_matrix_grad(
        up.double().abs(), x1.double(), x2.double(), ls.double(),
        var.double(), kind)]
    _assert_grad_within(got, ref.gp_kernel_matrix_grad(up, x1, x2, ls, var,
                                                       kind), scale, 1e-5)
    if not same:
        ls_, var_ = ls.clone().requires_grad_(), var.clone().requires_grad_()
        want = torch.autograd.grad(
            ref.gp_kernel_matrix(x1, x2, ls_, var_, kind), (ls_, var_), up)
        _assert_grad_within(got, want, scale, 1e-4)


@pytest.mark.parametrize("d", range(1, 17))
@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_kernel_matrix_and_grad_every_dim(cuda, d, kind):
    """Each input width is its own template instance of the forward and
    the gradient kernels: every one against its plain version."""
    up, x1, x2, ls, var = _grad_case(70, 45, d, False, cuda, seed=d)
    torch.testing.assert_close(
        gp_kernel.gp_kernel_matrix(x1, x2, ls, var, kind),
        ref.gp_kernel_matrix(x1, x2, ls, var, kind), atol=2e-5, rtol=2e-5)
    scale = [t.double() for t in ref.gp_kernel_matrix_grad(
        up.double().abs(), x1.double(), x2.double(), ls.double(),
        var.double(), kind)]
    _assert_grad_within(gp_kernel.gp_kernel_matrix_grad(up, x1, x2, ls, var,
                                                        kind),
                        ref.gp_kernel_matrix_grad(up, x1, x2, ls, var, kind),
                        scale, 1e-5)


def test_kernel_matrix_grad_is_deterministic(cuda):
    args = _grad_case(2048, 2048, 7, True, cuda)
    first = gp_kernel.gp_kernel_matrix_grad(*args, "matern52")
    second = gp_kernel.gp_kernel_matrix_grad(*args, "matern52")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,column_major", [(256, False), (2048, False),
                                           (256, True)])
def test_kernel_matrix_backward_launches_two_kernels(cuda, n, column_major):
    """A backward through `gp_kernel_matrix` is the gradient's two kernels
    and nothing else on the device, also for the column-major upstream
    gradient autograd hands over from the Cholesky."""
    up, x1, _, ls, var = _grad_case(n, n, 7, True, cuda)
    if column_major:
        up = up.T.contiguous().T
    ls.requires_grad_()
    var.requires_grad_()
    k = gp_kernel.gp_kernel_matrix(x1, x1, ls, var)
    calls = 4
    counts = _device_kernel_counts(
        lambda: torch.autograd.grad(k, (ls, var), up, retain_graph=True),
        calls, per_call=2)
    assert len(counts) == 2 and sum(counts.values()) == 2 * calls, counts
    for phase in ("gp_kernel_matrix_grad_tiles",
                  "gp_kernel_matrix_grad_reduce"):
        assert [c for key, c in counts.items() if phase in key] == [calls], \
            counts


def test_fit_on_card_matches_cpu(cuda):
    """40 Adam steps of the GP fit on the card and on the CPU, from the
    same data: the final NLML and log-parameters agree."""
    from repro_torch.uq import gp
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    y = np.stack([np.sin(x[:, 0]), x[:, 1] * x[:, 2]], 1)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        xt, yt = gp.as_f32(x, dev), gp.as_f32(y, dev)
        mean, std = gp._standardise(yt)
        tree, losses = gp._fit(xt, (yt - mean) / std, "rbf", 40, 5e-2)
        out[dev.type] = (losses[-1].cpu(), {k: v.cpu()
                                            for k, v in tree.items()})
    (card_loss, card), (cpu_loss, cpu) = out["cuda"], out["cpu"]
    torch.testing.assert_close(card_loss, cpu_loss, atol=1e-3, rtol=1e-3)
    for key in cpu:
        torch.testing.assert_close(card[key], cpu[key], atol=1e-3, rtol=1e-3)


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
    with pytest.raises(ValueError, match="shape"):
        gp_kernel.gp_kernel_matrix_grad(torch.ones(12, 10, device=cuda), x1,
                                        x2, ls, var)
    with pytest.raises(ValueError, match="float32"):
        gp_kernel.gp_kernel_matrix_grad(
            torch.ones(10, 12, device=cuda, dtype=torch.float64), x1, x2, ls,
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


# --------------------------------------------------------------------------
# LM kernels
# --------------------------------------------------------------------------
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_inputs(b, sq, skv, h, hkv, dh, dv, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, h, dh, generator=g)
    k = torch.randn(b, skv, hkv, dh, generator=g)
    v = torch.randn(b, skv, hkv, dv, generator=g)
    return [t.to(dtype).to(dev) for t in (q, k, v)]


# (b, sq, skv, h, hkv, dh, dv)
@pytest.mark.parametrize("shape", [
    (1, 1, 128, 4, 2, 64, 64),         # one query row (decode-like)
    (2, 64, 256, 8, 2, 64, 64),        # Sq < Skv: diagonal offset 192
    (1, 37, 50, 4, 2, 24, 40),         # Dv != Dh, ragged tiles
    (1, 777, 777, 32, 32, 80, 80),     # zamba2's heads, ragged S
    (1, 300, 300, 24, 2, 128, 128),    # starcoder2's GQA group of 12
    (1, 65, 65, 2, 1, 256, 256),       # widest head taken
    (1, 50, 50, 4, 2, 20, 12),         # rows not 16-byte aligned
    (1, 130, 130, 4, 4, 192, 128),     # MLA's Dh 192, Dv 128
    (1, 2048, 2048, 8, 8, 80, 80),     # serve max_len: many KV stages
    (1, 1024, 1024, 40, 40, 96, 64),   # minicpm3's MLA prefill, S=1024
    (1, 333, 333, 40, 40, 96, 64),     # minicpm3's MLA widths, ragged S
    (1, 300, 300, 40, 8, 128, 128),    # qwen3-14b's GQA group of 5
    (1, 1024, 1024, 48, 8, 128, 128),  # dbrx-132b's GQA prefill, S=1024
    (1, 1024, 1024, 128, 128, 192, 128),   # deepseek-v3's MLA prefill
    (2, 1024, 1024, 32, 32, 96, 96),   # phi-3-vision's train shape, MHA
    (1, 1024, 1024, 32, 32, 64, 64),   # musicgen's train microbatch, MHA
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, shape, causal, dtype):
    q, k, v = _attn_inputs(*shape, dtype, cuda)
    before = fa_kernel.launches["flash_attention"]
    got = fa_kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_kernel.launches["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (*q.shape[:3], v.shape[3])
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               ref.attention(q, k, v, causal=causal).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [
    (1, 300, 300, 8, 8, 80, 80),       # zamba2's heads
    (1, 300, 300, 24, 2, 128, 128),    # starcoder2's GQA group of 12
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_peaked_softmax(cuda, shape, causal):
    """q scaled by 8: scores of spread ~8, a softmax close to one-hot,
    where the bf16 rounding of P before P V weighs most."""
    q, k, v = _attn_inputs(*shape, torch.bfloat16, cuda, seed=2)
    q = q * 8
    got = fa_kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               ref.attention(q, k, v, causal=causal).float(),
                               atol=2e-2, rtol=2e-2)


def test_flash_attention_bf16_is_deterministic(cuda):
    """No atomics and no order that varies: two calls give the same bits."""
    q, k, v = _attn_inputs(1, 777, 777, 32, 32, 80, 80, torch.bfloat16,
                           cuda, seed=3)
    first = fa_kernel.flash_attention(q, k, v)
    second = fa_kernel.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_attention_rejects_bad_operands(cuda):
    q, k, v = _attn_inputs(1, 8, 8, 4, 2, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        fa_kernel.flash_attention(q, k[:, :4], v[:, :4])
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa_kernel.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="group"):
        fa_kernel.flash_attention(q[:, :, :3].contiguous(), k, v)
    wide = _attn_inputs(1, 4, 4, 1, 1, 264, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa_kernel.flash_attention(*wide)


def _ssd_inputs(b, s, h, p, n, dtype, dev, with_state, seed=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g))
    a = -torch.exp(0.3 * torch.randn(h, generator=g))
    bi = torch.randn(b, s, n, generator=g)
    ci = torch.randn(b, s, n, generator=g)
    d = torch.randn(h, generator=g)
    st = 0.1 * torch.randn(b, h, p, n, generator=g) if with_state else None
    out = [x.to(dtype), dt, a, bi.to(dtype), ci.to(dtype), d, st]
    return [None if t is None else t.to(dev) for t in out]


# (b, s, h, p, n)
SSD_SHAPES = [
    (2, 100, 3, 8, 16),
    (1, 31, 1, 8, 8),
    (2, 130, 4, 20, 128),      # P not a multiple of 16, widest N
    (1, 777, 80, 64, 64),      # zamba2's widths, ragged S
    (1, 1, 4, 64, 64),         # one step
    (1, 64, 4, 64, 64),        # exactly one chunk
    (2, 65, 3, 64, 64),        # one step into a second chunk
    (1, 4096, 8, 64, 64),      # 64 chunks of state passing
]


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_ssd_matches_plain(cuda, shape, with_state, dtype):
    args = _ssd_inputs(*shape, dtype, cuda, with_state)
    before = ssd_kernel.launches["mamba2_ssd"]
    y, st = ssd_kernel.mamba2_ssd(*args, chunk=256)
    torch.cuda.synchronize()
    assert ssd_kernel.launches["mamba2_ssd"] == before + 1
    wy, wst = ref.mamba2_ssd(*args, chunk=256)
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    assert y.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, wst, atol=tol, rtol=tol)


def test_mamba2_ssd_zero_dt_passes_state_through(cuda):
    """With dt == 0 the state passes through exactly, and from a zero
    state y is exactly the D-skip."""
    x, dt, a, bi, ci, d, st = _ssd_inputs(1, 100, 2, 8, 16, torch.float32,
                                          cuda, True)
    dt = torch.zeros_like(dt)
    y, fs = ssd_kernel.mamba2_ssd(x, dt, a, bi, ci, d, st)
    assert torch.equal(fs, st)
    y, fs = ssd_kernel.mamba2_ssd(x, dt, a, bi, ci, d, torch.zeros_like(st))
    assert torch.equal(y, d[None, None, :, None] * x)
    assert torch.equal(fs, torch.zeros_like(st))


def test_mamba2_ssd_strong_decay_matches_sequential(cuda):
    """A = -8: a chunk's log decays sum to about -550, far below where
    exp(-cum) overflows; the kernel stays finite and equals the
    sequential recurrence."""
    x, dt, _, bi, ci, d, st = _ssd_inputs(1, 300, 4, 64, 64, torch.float32,
                                          cuda, True)
    a = torch.full((4,), -8.0, device=cuda)
    y, fs = ssd_kernel.mamba2_ssd(x, dt, a, bi, ci, d, st)
    assert torch.isfinite(y).all() and torch.isfinite(fs).all()
    wy, wfs = ref.mamba2_ssd_scan(x, dt, a, bi, ci, d, st)
    torch.testing.assert_close(y, wy, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(fs, wfs, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_ssd_split_prefill_equals_one(cuda, dtype):
    """ssd(300 + 200) against ssd(200, state = ssd(300)): serving feeds
    the cached state back this way, and 300 is not a multiple of the
    chunk, so the two runs cut the sequence at different steps."""
    x, dt, a, bi, ci, d, st = _ssd_inputs(1, 500, 8, 64, 64, dtype, cuda,
                                          True, seed=11)
    whole = ssd_kernel.mamba2_ssd(x, dt, a, bi, ci, d, st)
    parts = [t[:, :300].contiguous() for t in (x, dt, bi, ci)]
    y1, st1 = ssd_kernel.mamba2_ssd(parts[0], parts[1], a, parts[2],
                                    parts[3], d, st)
    parts = [t[:, 300:].contiguous() for t in (x, dt, bi, ci)]
    y2, st2 = ssd_kernel.mamba2_ssd(parts[0], parts[1], a, parts[2],
                                    parts[3], d, st1)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(torch.cat([y1, y2], 1).float(),
                               whole[0].float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st2, whole[1], atol=2e-3, rtol=2e-3)


def test_mamba2_ssd_d_in_the_activation_type(cuda):
    """The model passes its bf16 D-skip as it is: d in x's type matches the
    plain version, which takes d in f32 after the same rounding."""
    x, dt, a, bi, ci, d, st = _ssd_inputs(2, 130, 8, 64, 64, torch.bfloat16,
                                          cuda, True)
    d16 = d.to(torch.bfloat16)
    y, fs = ssd_kernel.mamba2_ssd(x, dt, a, bi, ci, d16, st)
    wy, wfs = ref.mamba2_ssd(x, dt, a, bi, ci, d16.float(), st, chunk=256)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), wy.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(fs, wfs, atol=2e-3, rtol=2e-3)


def test_mamba2_ssd_launches_three_kernels_per_call(cuda):
    """One wrapper call is the three phases and nothing else on the device
    (no cast or D-skip pass): a profiler window of calls holds exactly
    three kernels per call, one of each phase."""
    args = _ssd_inputs(1, 300, 8, 64, 64, torch.bfloat16, cuda, True)
    calls = 4
    counts = _device_kernel_counts(lambda: ssd_kernel.mamba2_ssd(*args),
                                   calls)
    assert len(counts) == 3 and sum(counts.values()) == 3 * calls, counts
    for phase in ("ssd_chunk_state", "ssd_state_scan", "ssd_chunk_output"):
        assert [c for k, c in counts.items() if phase in k] == [calls], counts


def test_mamba2_ssd_rejects_bad_operands(cuda):
    x, dt, a, bi, ci, d, st = _ssd_inputs(1, 20, 2, 16, 16, torch.bfloat16,
                                          cuda, True)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.mamba2_ssd(x.cpu(), dt, a, bi, ci, d, st)
    with pytest.raises(ValueError, match="bfloat16"):
        ssd_kernel.mamba2_ssd(x, dt, a, bi.float(), ci, d, st)
    with pytest.raises(ValueError, match="float32"):
        ssd_kernel.mamba2_ssd(x, dt, a, bi, ci, d.double(), st)
    with pytest.raises(ValueError, match="float32"):
        ssd_kernel.mamba2_ssd(x, dt.to(torch.bfloat16), a, bi, ci, d, st)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_kernel.mamba2_ssd(x.transpose(1, 2), dt, a, bi, ci, d, st)
    with pytest.raises(ValueError, match="shape"):
        ssd_kernel.mamba2_ssd(x, dt, a, bi, ci, d[:1].contiguous(), st)
    with pytest.raises(ValueError, match="state width"):
        wide = _ssd_inputs(1, 4, 1, 8, 136, torch.float32, cuda, False)
        ssd_kernel.mamba2_ssd(*wide)
    with pytest.raises(ValueError, match="chunk"):
        ssd_kernel.mamba2_ssd(x, dt, a, bi, ci, d, st, chunk=0)


SSD_GRADS = ("dx", "ddt", "da", "db", "dc", "dd", "dstate")


def _ssd_bwd_inputs(shape, dtype, dev, with_state, d_type=torch.float32,
                    seed=13):
    """`_ssd_inputs`, d in `d_type`, then dy in x's type and dstate_out
    f32, and the forward's chunk states."""
    x, dt, a, bi, ci, d, st = _ssd_inputs(*shape, dtype, dev, with_state,
                                          seed=seed)
    d = d.to(d_type)
    g = torch.Generator().manual_seed(seed + 1)
    b, s, h, p, n = shape
    dy = torch.randn(b, s, h, p, generator=g).to(dtype).to(dev)
    dso = torch.randn(b, h, p, n, generator=g).to(dev)
    _, _, states = ssd_kernel.mamba2_ssd(x, dt, a, bi, ci, d, st,
                                         return_states=True)
    return (x, dt, a, bi, ci, d, st), dy, dso, states


def _assert_ssd_grads_close(got, want, rel_bf16=2 ** -8):
    """Each gradient within 1e-4 max|g| of the plain version's (f32 sums in
    another order); a bf16 one also within one rounding of the result
    (2^-8 relative), which both take once from f32."""
    for name, g, w in zip(SSD_GRADS, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = float(w.float().abs().max())
        rel = 1e-4 + (rel_bf16 if g.dtype == torch.bfloat16 else 0.0)
        err = float((g.float() - w.float()).abs().max())
        assert torch.isfinite(g).all() and err <= rel * scale, (name, err,
                                                                scale)


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_ssd_bwd_matches_plain(cuda, shape, with_state, dtype):
    args, dy, dso, states = _ssd_bwd_inputs(shape, dtype, cuda, with_state)
    before = ssd_kernel.launches["mamba2_ssd_bwd"]
    got = ssd_kernel.mamba2_ssd_bwd(*args, dy, dso, states=states)
    torch.cuda.synchronize()
    assert ssd_kernel.launches["mamba2_ssd_bwd"] == before + 1
    _assert_ssd_grads_close(got, ref.mamba2_ssd_bwd(*args, dy, dso))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_ssd_bwd_d_in_the_activation_type_and_no_state_gradient(
        cuda, dtype):
    """The model's D-skip in x's type gets its gradient in that type; a
    final state whose gradient is None is a zero cotangent."""
    args, dy, _, states = _ssd_bwd_inputs((2, 130, 8, 64, 64), dtype, cuda,
                                          True, d_type=dtype)
    got = ssd_kernel.mamba2_ssd_bwd(*args, dy, None, states=states)
    assert got[5].dtype == dtype
    _assert_ssd_grads_close(got, ref.mamba2_ssd_bwd(*args, dy, None))


def test_mamba2_ssd_bwd_strong_decay_matches_sequential(cuda):
    """a = -8: the chunks' log decays sum to about -550.  The backward
    stays finite and matches autograd of the sequential recurrence in
    f64 (the plain chunked form's own f32 gap there is 1.7e-5)."""
    args, dy, dso, states = _ssd_bwd_inputs((1, 300, 4, 64, 64),
                                            torch.float32, cuda, True)
    args = list(args)
    args[2] = torch.full((4,), -8.0, device=cuda)
    _, _, states = ssd_kernel.mamba2_ssd(*args, return_states=True)
    got = ssd_kernel.mamba2_ssd_bwd(*args, dy, dso, states=states)
    leaves = [t.double().requires_grad_() for t in args]
    y, fin = ref.mamba2_ssd_scan(*leaves)
    want = torch.autograd.grad((y, fin), leaves, (dy.double(), dso.double()))
    _assert_ssd_grads_close(got, [w.float() for w in want])


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_ssd_bwd_bf16_train_shape_strong_decay(cuda, with_state):
    """zamba2's training shape (B 2, S 1024, 80 heads of 64, N 64) in bf16
    under a strong decay (a = -8): the bf16 route multiplies on the
    tensor cores with its f32 operands split into bf16 pieces, and its
    f32 outputs (ddt, da and, with a state, dstate) stay within 1e-4
    max|g| of the plain version, the bf16 ones within one rounding more.
    Without a state and a final state's gradient, as a training step
    calls it; with both, for dstate."""
    args, dy, dso, _ = _ssd_bwd_inputs((2, 1024, 80, 64, 64),
                                       torch.bfloat16, cuda, with_state)
    args = list(args)
    args[2] = torch.full((80,), -8.0, device=cuda)
    dso = dso if with_state else None
    _, _, states = ssd_kernel.mamba2_ssd(*args, return_states=True)
    got = ssd_kernel.mamba2_ssd_bwd(*args, dy, dso, states=states)
    torch.cuda.synchronize()
    _assert_ssd_grads_close(got, ref.mamba2_ssd_bwd(*args, dy, dso))


@pytest.mark.parametrize("shape", [(1, 130, 3, 80, 64), (2, 100, 2, 136, 16),
                                   (1, 70, 2, 200, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_ssd_bwd_p_over_several_tiles(cuda, shape, dtype):
    """P wider than one 64-column tile: the chunk gradients walk P in
    tiles twice (dy x^T, S^T dy and G^T x; then dxdt), reloading each
    tile, against the plain version."""
    args, dy, dso, states = _ssd_bwd_inputs(shape, dtype, cuda, True)
    got = ssd_kernel.mamba2_ssd_bwd(*args, dy, dso, states=states)
    torch.cuda.synchronize()
    _assert_ssd_grads_close(got, ref.mamba2_ssd_bwd(*args, dy, dso))


def test_mamba2_ssd_bwd_is_deterministic(cuda):
    """dB and dC sum the heads, da and dD the chunks, in a fixed order with
    no atomics: two calls on the same inputs agree bit for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        args, dy, dso, states = _ssd_bwd_inputs((2, 777, 80, 64, 64), dtype,
                                                cuda, True)
        first = ssd_kernel.mamba2_ssd_bwd(*args, dy, dso, states=states)
        again = ssd_kernel.mamba2_ssd_bwd(*args, dy, dso, states=states)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_mamba2_ssd_bwd_launches_four_kernels_per_call(cuda):
    """One backward call is its four kernels and nothing else on the
    device: the state gradient's increments, the reverse scan, the chunk
    gradients and the fixed-order reduction."""
    args, dy, dso, states = _ssd_bwd_inputs((1, 300, 8, 64, 64),
                                            torch.bfloat16, cuda, True)
    calls = 4
    counts = _device_kernel_counts(
        lambda: ssd_kernel.mamba2_ssd_bwd(*args, dy, dso, states=states),
        calls, per_call=4)
    assert len(counts) == 4 and sum(counts.values()) == 4 * calls, counts
    for phase in ("ssd_bwd_state_inc", "ssd_bwd_state_scan",
                  "ssd_bwd_chunk_grad", "ssd_bwd_reduce"):
        assert [c for k, c in counts.items() if phase in k] == [calls], counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_mamba2_ssd_under_grad_goes_through_the_function(cuda, dtype):
    """`ops.mamba2_ssd` with a gradient recorded takes `Mamba2SSD`: one
    forward and one backward launch, gradients equal to the plain
    backward's (the final state's gradient None: a loss of y alone).
    Without a gradient it launches the forward alone, with no graph."""
    from repro_torch.kernels import ops
    (x, dt, a, bi, ci, d, st), dy, _, _ = _ssd_bwd_inputs(
        (2, 200, 4, 64, 64), dtype, cuda, True)
    leaves = [t.requires_grad_() for t in (x, dt, a, bi, ci, d, st)]
    ssd_kernel.reset_launches()
    y, fin = ops.mamba2_ssd(*leaves)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, dy)
    assert dict(ssd_kernel.launches) == {"mamba2_ssd": 1,
                                         "mamba2_ssd_bwd": 1}
    plain = [t.detach() for t in leaves]
    _assert_ssd_grads_close(got, ref.mamba2_ssd_bwd(*plain, dy, None))
    with torch.no_grad():
        y, _ = ops.mamba2_ssd(*leaves)
    assert y.grad_fn is None
    assert dict(ssd_kernel.launches) == {"mamba2_ssd": 2,
                                         "mamba2_ssd_bwd": 1}


def test_mamba2_ssd_bwd_rejects_bad_operands(cuda):
    args, dy, dso, states = _ssd_bwd_inputs((1, 70, 2, 16, 16),
                                            torch.bfloat16, cuda, True)

    def call(**kw):
        kw = {"dy": dy, "dstate_out": dso, "states": states, **kw}
        return ssd_kernel.mamba2_ssd_bwd(*args, kw["dy"], kw["dstate_out"],
                                         states=kw["states"])
    with pytest.raises(ValueError, match="dy"):
        call(dy=dy.float())
    with pytest.raises(ValueError, match="dy"):
        call(dy=dy[:, :10].contiguous())
    with pytest.raises(ValueError, match="states"):
        call(states=states[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="dstate_out"):
        call(dstate_out=dso.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        call(dy=dy.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        call(dy=dy.transpose(1, 2))


def _wkv_inputs(b, s, h, kd, vd, dtype, dev, with_state, log_w=None,
                seed=9):
    """r, k, v, u ~ N(0, 1) in `dtype`; w = exp(-exp(N(0, 0.5) - 1)) (log w
    in about [-1, -0.1], as at random init) or the constant exp(log_w)."""
    g = torch.Generator().manual_seed(seed)
    r, k = (torch.randn(b, s, h, kd, generator=g) for _ in range(2))
    v = torch.randn(b, s, h, vd, generator=g)
    if log_w is None:
        w = torch.exp(-torch.exp(0.5 * torch.randn(b, s, h, kd, generator=g)
                                 - 1.0))
    else:
        w = torch.full((b, s, h, kd), float(np.exp(log_w)))
    u = torch.randn(h, kd, generator=g)
    st = 0.1 * torch.randn(b, h, kd, vd, generator=g) if with_state else None
    out = [r.to(dtype), k.to(dtype), v.to(dtype), w, u.to(dtype), st]
    return [None if t is None else t.to(dev) for t in out]


def _assert_wkv_close(got, want, dtype):
    (y, st), (wy, wst) = got, want
    assert y.dtype == dtype and st.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    if dtype == torch.float32:
        torch.testing.assert_close(y, wy, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(st, wst, atol=2e-4, rtol=2e-4)
    else:
        yf, wyf = y.float(), wy.float()
        assert ((yf - wyf).abs() <= 2e-2 + 2e-2 * wyf.abs()).all()
        assert ((st - wst).abs() <= 2e-3 + 2e-3 * wst.abs()).all()


# (b, s, h, k, v)
@pytest.mark.parametrize("shape", [
    (2, 130, 3, 16, 16),
    (1, 33, 1, 8, 8),
    (2, 100, 2, 32, 24),       # V not a multiple of 16
    (1, 70, 2, 128, 16),       # widest K
    (1, 777, 40, 64, 64),      # rwkv6-3b's widths, ragged S
    (2, 333, 5, 64, 64),       # B = 2, ragged S: every phase's (chunk,
                               # batch * head) indexing crossed
    (2, 150, 3, 20, 100),      # K not a multiple of 8; two V slices
    (1, 130, 2, 64, 128),      # vectorised loads over two V slices
    (2, 65, 2, 7, 10),         # padded K, V not a multiple of 4
])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_wkv_matches_plain(cuda, shape, with_state, dtype):
    args = _wkv_inputs(*shape, dtype, cuda, with_state)
    before = wkv_kernel.launches["rwkv6_wkv"]
    got = wkv_kernel.rwkv6_wkv(*args)
    torch.cuda.synchronize()
    assert wkv_kernel.launches["rwkv6_wkv"] == before + 1
    _assert_wkv_close(got, ref.rwkv6_wkv(*args), dtype)


@pytest.mark.parametrize("log_w", [-1.5, -3.0, -69.0])
def test_rwkv6_wkv_strong_decay_matches_sequential(cuda, log_w):
    """Where a chunk's log-decays sum far below -88 the kernel stays
    finite and equals the sequential recurrence."""
    args = _wkv_inputs(1, 200, 2, 64, 64, torch.float32, cuda, True,
                       log_w=log_w)
    got = wkv_kernel.rwkv6_wkv(*args)
    _assert_wkv_close(got, ref.rwkv6_wkv_scan(*args), torch.float32)


@pytest.mark.parametrize("s1", [1, 100, 777])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_wkv_split_prefill_equals_one(cuda, s1, dtype):
    """wkv(S1 + S2) against wkv(S2, state = wkv(S1)): serving feeds the
    cached state back this way.  S1 is not a multiple of the chunk, so
    the two runs cut the sequence at different steps."""
    r, k, v, w, u, st = _wkv_inputs(1, s1 + 300, 40, 64, 64, dtype, cuda,
                                    True, seed=11)
    whole = wkv_kernel.rwkv6_wkv(r, k, v, w, u, st)
    y1, st1 = wkv_kernel.rwkv6_wkv(r[:, :s1].contiguous(),
                                   k[:, :s1].contiguous(),
                                   v[:, :s1].contiguous(),
                                   w[:, :s1].contiguous(), u, st)
    y2, st2 = wkv_kernel.rwkv6_wkv(r[:, s1:].contiguous(),
                                   k[:, s1:].contiguous(),
                                   v[:, s1:].contiguous(),
                                   w[:, s1:].contiguous(), u, st1)
    torch.cuda.synchronize()
    _assert_wkv_close((torch.cat([y1, y2], 1), st2), whole, dtype)


def test_rwkv6_wkv_unit_decay_and_zero_keys(cuda):
    """With k = 0 the state only decays and the output is its readout;
    with w = 1 as well the state passes through exactly."""
    r, k, v, w, u, st = _wkv_inputs(1, 90, 2, 16, 16, torch.float32, cuda,
                                    True)
    k = torch.zeros_like(k)
    _, fs = wkv_kernel.rwkv6_wkv(r, k, v, torch.ones_like(w), u, st)
    assert torch.equal(fs, st)
    y, fs = wkv_kernel.rwkv6_wkv(r, k, v, w, u, st)
    _assert_wkv_close((y, fs), ref.rwkv6_wkv_scan(r, k, v, w, u, st),
                      torch.float32)


def test_rwkv6_wkv_rejects_bad_operands(cuda):
    r, k, v, w, u, st = _wkv_inputs(1, 20, 2, 16, 16, torch.bfloat16, cuda,
                                    True)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_kernel.rwkv6_wkv(r.cpu(), k, v, w, u, st)
    with pytest.raises(ValueError, match="float32"):
        wkv_kernel.rwkv6_wkv(r, k, v, w.to(torch.bfloat16), u, st)
    with pytest.raises(ValueError, match="bfloat16"):
        wkv_kernel.rwkv6_wkv(r, k.float(), v, w, u, st)
    with pytest.raises(ValueError, match="float32"):
        wkv_kernel.rwkv6_wkv(r, k, v, w, u, st.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        wkv_kernel.rwkv6_wkv(r.transpose(1, 2), k, v, w, u, st)
    with pytest.raises(ValueError, match="shape"):
        wkv_kernel.rwkv6_wkv(r, k, v, w, u[:1].contiguous(), st)
    with pytest.raises(ValueError, match="key width"):
        wide = _wkv_inputs(1, 4, 1, 136, 8, torch.float32, cuda, False)
        wkv_kernel.rwkv6_wkv(*wide)
    with pytest.raises(ValueError, match="chunk"):
        wkv_kernel.rwkv6_wkv(r, k, v, w, u, st, chunk=0)


WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "dstate")


def _wkv_bwd_inputs(shape, dtype, dev, with_state, log_w=None, seed=9):
    """`_wkv_inputs`, then do in r's type and dstate_out f32, and the
    forward's chunk states."""
    args = _wkv_inputs(*shape, dtype, dev, with_state, log_w=log_w,
                       seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    b, s, h, kd, vd = shape
    do = torch.randn(b, s, h, vd, generator=g).to(dtype).to(dev)
    dso = torch.randn(b, h, kd, vd, generator=g).to(dev)
    _, _, states = wkv_kernel.rwkv6_wkv(*args, return_states=True)
    return args, do, dso, states


def _assert_wkv_grads_close(got, want, w, rel_bf16=2 ** -8):
    """Each gradient within 1e-4 of its max|g| of the plain version's (f32
    sums in another order); a bf16 one also within one rounding of the
    result (2^-8 relative).  dw as w o dw, the log decay's gradient: dw
    itself spans w's decades."""
    for name, g, x in zip(WKV_GRADS, got, want):
        if x is None:
            assert g is None, name
            continue
        assert g.dtype == x.dtype and g.shape == x.shape, name
        assert torch.isfinite(g).all(), name
        g, x = g.double(), x.double()
        if name == "dw":
            g, x = g * w.double(), x * w.double()
        scale = float(x.abs().max())
        rel = 1e-4 + (rel_bf16 if got[0].dtype == torch.bfloat16
                      and name in ("dr", "dk", "dv", "du") else 0.0)
        err = float((g - x).abs().max())
        assert err <= rel * scale, (name, err, scale)


# (b, s, h, k, v)
WKV_BWD_SHAPES = [
    (2, 130, 3, 16, 16),
    (1, 33, 1, 8, 8),          # one ragged chunk
    (2, 100, 2, 32, 24),       # V not a multiple of 16
    (2, 65, 2, 7, 10),         # padded K, V; one step into a second chunk
    (1, 777, 40, 64, 64),      # rwkv6-3b's widths, ragged S
    (2, 333, 5, 64, 64),       # B = 2: the (b, chunk) partials of du
]


@pytest.mark.parametrize("shape", WKV_BWD_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_wkv_bwd_matches_plain(cuda, shape, with_state, dtype):
    args, do, dso, states = _wkv_bwd_inputs(shape, dtype, cuda, with_state)
    dso = dso if with_state else None
    before = wkv_kernel.launches["rwkv6_wkv_bwd"]
    got = wkv_kernel.rwkv6_wkv_bwd(*args, do, dso, states=states)
    torch.cuda.synchronize()
    assert wkv_kernel.launches["rwkv6_wkv_bwd"] == before + 1
    _assert_wkv_grads_close(got, ref.rwkv6_wkv_bwd(*args, do, dso), args[3])


def test_rwkv6_wkv_bwd_train_shape(cuda):
    """rwkv6-3b's training shape (B 2, S 1024, 40 heads of 64) in bf16,
    with no state and no final state's gradient, as a training step calls
    it."""
    args, do, _, states = _wkv_bwd_inputs((2, 1024, 40, 64, 64),
                                          torch.bfloat16, cuda, False)
    got = wkv_kernel.rwkv6_wkv_bwd(*args, do, None, states=states)
    torch.cuda.synchronize()
    _assert_wkv_grads_close(got, ref.rwkv6_wkv_bwd(*args, do, None), args[3])


@pytest.mark.parametrize("log_w", [-1.5, -3.0, -69.0])
def test_rwkv6_wkv_bwd_strong_decay_matches_sequential(cuda, log_w):
    """A chunk's log decays summing far below -88: the backward stays
    finite and matches autograd of the sequential recurrence in f64."""
    args, do, dso, states = _wkv_bwd_inputs((1, 200, 2, 64, 64),
                                            torch.float32, cuda, True,
                                            log_w=log_w)
    got = wkv_kernel.rwkv6_wkv_bwd(*args, do, dso, states=states)
    leaves = [t.double().requires_grad_() for t in args]
    out, fin = ref.rwkv6_wkv_scan(*leaves)
    want = torch.autograd.grad((out, fin), leaves,
                               (do.double(), dso.double()))
    _assert_wkv_grads_close(got, [x.float() for x in want], args[3])


@pytest.mark.parametrize("log_w", [-1.5, -69.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_wkv_bwd_zero_state_strong_decay_matches_sequential(
        cuda, dtype, log_w):
    """As a training step calls it: no state and no final state's
    gradient, under a strong decay.  Every decay in the kernel is a product
    of max(w, 1e-30) over its own steps, so the gradient, dw included,
    matches autograd of the sequential recurrence in f64 (on the same
    bf16 values where the operands are bf16)."""
    args, do, _, states = _wkv_bwd_inputs((1, 200, 2, 64, 64), dtype, cuda,
                                          False, log_w=log_w)
    got = wkv_kernel.rwkv6_wkv_bwd(*args, do, None, states=states)
    leaves = [t.double().requires_grad_() for t in args[:5]]
    out, _ = ref.rwkv6_wkv_scan(*leaves)
    want = torch.autograd.grad(out, leaves, do.double())
    _assert_wkv_grads_close(
        got, [x.to(g.dtype) for x, g in zip(want, got)] + [None], args[3])


def test_rwkv6_wkv_bwd_clamps_w_at_1e30(cuda):
    """w on both sides of the clamp at 1e-30, some of it 0: the kernel
    decays by max(w, 1e-30) and gives dw = 0 below it, as the plain
    version does, every other gradient equal to the plain version's."""
    for dtype in (torch.float32, torch.bfloat16):
        args, do, dso, _ = _wkv_bwd_inputs((2, 150, 3, 64, 64), dtype, cuda,
                                           True)
        g = torch.Generator().manual_seed(12)
        pick = torch.rand(args[3].shape, generator=g).to(cuda)
        near = 10.0 ** (-31.0 + 2.0 * torch.rand(args[3].shape,
                                                 generator=g)).to(cuda)
        args[3] = torch.where(pick < 0.3, near, args[3])
        args[3] = torch.where(pick > 0.97, torch.zeros_like(near), args[3])
        _, _, states = wkv_kernel.rwkv6_wkv(*args, return_states=True)
        got = wkv_kernel.rwkv6_wkv_bwd(*args, do, dso, states=states)
        below = args[3] < 1e-30
        assert bool(below.any()) and (got[3][below] == 0).all()
        _assert_wkv_grads_close(got, ref.rwkv6_wkv_bwd(*args, do, dso),
                                args[3].clamp_min(1e-30))


def test_rwkv6_wkv_bwd_chunk_grad_holds_two_blocks_per_sm(cuda):
    """The bf16 chunk gradients at rwkv6-3b's head width (K = V = 64) fit
    two blocks on an SM (shared memory and registers, CUDA's occupancy
    calculator); the f32 ones at least one."""
    bf = wkv_kernel.bwd_blocks_per_sm(torch.bfloat16, 64)
    f32 = wkv_kernel.bwd_blocks_per_sm(torch.float32, 64)
    assert tuple(bf) == wkv_kernel.BWD_KERNELS
    assert bf["wkv_bwd_chunk_grad"] >= 2, bf
    assert min(f32.values()) >= 1, f32


def test_rwkv6_wkv_bwd_is_deterministic(cuda):
    """du sums the batch and the chunks in a fixed order with no atomics:
    two calls on the same inputs agree bit for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        args, do, dso, states = _wkv_bwd_inputs((2, 777, 40, 64, 64), dtype,
                                                cuda, True)
        first = wkv_kernel.rwkv6_wkv_bwd(*args, do, dso, states=states)
        again = wkv_kernel.rwkv6_wkv_bwd(*args, do, dso, states=states)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_rwkv6_wkv_bwd_launches_four_kernels_per_call(cuda):
    """One backward call is its four kernels and nothing else on the
    device."""
    args, do, dso, states = _wkv_bwd_inputs((1, 300, 8, 64, 64),
                                            torch.bfloat16, cuda, True)
    calls = 4
    counts = _device_kernel_counts(
        lambda: wkv_kernel.rwkv6_wkv_bwd(*args, do, dso, states=states),
        calls, per_call=4)
    assert len(counts) == 4 and sum(counts.values()) == 4 * calls, counts
    for phase in wkv_kernel.BWD_KERNELS:
        assert [c for k, c in counts.items() if phase in k] == [calls], counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_rwkv6_wkv_under_grad_goes_through_the_function(cuda, dtype):
    """`ops.rwkv6_wkv` with a gradient recorded takes `RWKV6WKV`: one
    forward and one backward launch, gradients equal to the plain
    backward's (the final state's gradient None: a loss of out alone).
    Without a gradient it launches the forward alone, with no graph; the
    raw wrapper refuses a gradient and names the Function."""
    from repro_torch.kernels import ops
    args, do, _, _ = _wkv_bwd_inputs((2, 200, 4, 64, 64), dtype, cuda, True)
    leaves = [t.requires_grad_() for t in args]
    wkv_kernel.reset_launches()
    out, _ = ops.rwkv6_wkv(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    assert dict(wkv_kernel.launches) == {"rwkv6_wkv": 1, "rwkv6_wkv_bwd": 1}
    plain = [t.detach() for t in leaves]
    _assert_wkv_grads_close(got, ref.rwkv6_wkv_bwd(*plain, do, None),
                            plain[3])
    with torch.no_grad():
        out, _ = ops.rwkv6_wkv(*leaves)
    assert out.grad_fn is None
    assert dict(wkv_kernel.launches) == {"rwkv6_wkv": 2, "rwkv6_wkv_bwd": 1}
    with pytest.raises(NotImplementedError, match="RWKV6WKV"):
        wkv_kernel.rwkv6_wkv(*leaves)


def test_rwkv6_wkv_bwd_rejects_bad_operands(cuda):
    args, do, dso, states = _wkv_bwd_inputs((1, 70, 2, 16, 16),
                                            torch.bfloat16, cuda, True)

    def call(**kw):
        kw = {"do": do, "dstate_out": dso, "states": states, **kw}
        return wkv_kernel.rwkv6_wkv_bwd(*args, kw["do"], kw["dstate_out"],
                                        states=kw["states"])
    with pytest.raises(ValueError, match="do"):
        call(do=do.float())
    with pytest.raises(ValueError, match="do"):
        call(do=do[:, :10].contiguous())
    with pytest.raises(ValueError, match="states"):
        call(states=states[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="dstate_out"):
        call(dstate_out=dso.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        call(do=do.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        call(do=do.transpose(1, 2))
    wide, do_w, _, st_w = _wkv_bwd_inputs((1, 20, 1, 96, 16),
                                          torch.float32, cuda, False)
    with pytest.raises(ValueError, match="K, V <= 64"):
        wkv_kernel.rwkv6_wkv_bwd(*wide, do_w, None, states=st_w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_ssd_bwd_da_from_a_zero_state_under_strong_decay(cuda,
                                                                dtype):
    """The training regime under a = -8 (no state, no final state's
    gradient): each in-chunk decay is summed from the log decays of its
    own steps, so da, small here against its terms, stays within 1e-4
    max|g| of autograd of the sequential recurrence in f64, on both
    routes (bf16 inputs held to the scan of the same rounded values)."""
    args, dy, _, _ = _ssd_bwd_inputs((2, 77, 2, 64, 64), dtype, cuda, False)
    args = list(args)
    args[2] = torch.full((2,), -8.0, device=cuda)
    _, _, states = ssd_kernel.mamba2_ssd(*args, return_states=True)
    got = ssd_kernel.mamba2_ssd_bwd(*args, dy, None, states=states)
    leaves = [t.double().requires_grad_() for t in args[:6]]
    y, _ = ref.mamba2_ssd_scan(*leaves)
    want = torch.autograd.grad(y, leaves, dy.double())
    for name, g, w in zip(SSD_GRADS, got, want):
        if name in ("ddt", "da") or dtype == torch.float32:
            scale = float(w.abs().max())
            err = float((g.double() - w).abs().max())
            assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "starcoder2-3b",
                                  "rwkv6-3b", "qwen3-14b", "yi-34b",
                                  "minicpm3-4b", "dbrx-132b",
                                  "deepseek-v3-671b", "phi-3-vision-4.2b",
                                  "musicgen-large"])
def test_reduced_model_on_card_matches_cpu(cuda, arch):
    """The same weights forward on the card (through the kernels) and on
    the CPU (plain versions), f32: logits at 1e-3 relative to max(|x|,1).
    The embedding-input archs take embeddings [B, S, D]."""
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get_reduced(arch)
    card = model.init_params(cfg, seed=3, device=cuda)
    cpu = model.LM(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    gen = torch.Generator().manual_seed(0)
    if cfg.input_mode == "embeddings":
        batch = {"embeddings": torch.randn(2, 40, cfg.d_model, generator=gen)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                         generator=gen)}
    fa_kernel.reset_launches()
    ssd_kernel.reset_launches()
    wkv_kernel.reset_launches()
    got, _, _ = model.forward(card, {k: v.to(cuda) for k, v in batch.items()},
                              cfg)
    torch.cuda.synchronize()
    if arch == "rwkv6-3b":
        assert wkv_kernel.launches["rwkv6_wkv"] == cfg.n_layers
    else:
        assert fa_kernel.launches["flash_attention"] >= 1
    if arch == "zamba2-2.7b":
        assert ssd_kernel.launches["mamba2_ssd"] == cfg.n_layers
    want, _, _ = model.forward(cpu, batch, cfg)
    err = ((got.cpu() - want).abs() / want.abs().clamp_min(1.0)).max()
    assert float(err) <= 1e-3


def test_reduced_mla_prefill_and_decode_on_card_match_cpu(cuda):
    """Reduced minicpm3-4b with the same weights on the card and on the
    CPU, f32: a 20-token prefill (through the kernel at Dh != Dv) into a
    32-position cache, then 4 absorbed decode steps; logits at 1e-3
    relative to max(|x|, 1) and the latent caches alike."""
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get_reduced("minicpm3-4b")
    card = model.init_params(cfg, seed=4, device=cuda)
    cpu = model.LM(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    caches = {"card": model.init_cache(cfg, 2, 32, cuda),
              "cpu": model.init_cache(cfg, 2, 32, "cpu")}
    fa_kernel.reset_launches()
    logits = {}
    for where, params in (("card", card), ("cpu", cpu)):
        dev = cuda if where == "card" else torch.device("cpu")
        out, _, _ = model.prefill(params, {"tokens": toks[:, :20].to(dev)},
                                  cfg, caches[where])
        steps = [out[:, -1]]
        for pos in range(20, 24):
            out, _ = model.decode_step(
                params, {"tokens": toks[:, pos:pos + 1].to(dev)}, cfg,
                caches[where], pos)
            steps.append(out)
        logits[where] = torch.stack(steps, 1).cpu()
    torch.cuda.synchronize()
    assert fa_kernel.launches["flash_attention"] == cfg.n_layers
    want = logits["cpu"]
    err = ((logits["card"] - want).abs() / want.abs().clamp_min(1.0)).max()
    assert float(err) <= 1e-3
    for name in ("c_kv", "k_rope"):
        got, ref_c = caches["card"]["layers"][name].cpu(), \
            caches["cpu"]["layers"][name]
        err = ((got - ref_c).abs() / ref_c.abs().clamp_min(1.0)).max()
        assert float(err) <= 1e-3, name


def _moe_case(dtype, seed=6):
    """A deepseek-style MoE layer (sigmoid router, a shared expert) at
    d 512, 16 experts of width 256, top-4, and 2 x 64 tokens, drawn on the
    CPU."""
    from repro_torch import configs
    from repro_torch.models import layers, moe
    cfg = configs.get_reduced("deepseek-v3-671b").replace(
        d_model=512, n_experts=16, moe_top_k=4, moe_d_ff=256, dtype=dtype)
    p = layers.init_params(moe.MoE(cfg, cfg.activation_dtype, "cpu"), seed)
    x = torch.randn(2, 64, 512, generator=torch.Generator().manual_seed(
        seed)).to(cfg.activation_dtype)
    return cfg, p, x


def _moe_run(p, x, cfg):
    from repro_torch.models import moe
    seen = []
    with moe.observe(lambda idx, keep, cap: seen.append((idx.cpu(),
                                                         keep.cpu()))):
        out, aux = moe.moe_apply(p, x, cfg)
    return out, aux, seen[0]


@pytest.mark.parametrize("factor", [0.5, 1.25])
def test_moe_apply_bf16_on_card(cuda, factor):
    """bf16 on the card: two calls give the same bits (no atomics in the
    combine), the routing (top-k indices and the kept assignments) equals
    the CPU's on the same weights, and the output is within 1e-2 of the
    CPU's relative to max(|x|, 1) (the same f32 sums in other orders; a
    sum on the other side of a bf16 rounding boundary moves a result by
    one bf16 step, 2^-8 relative)."""
    import copy
    cfg, cpu_p, x = _moe_case("bfloat16")
    cfg = cfg.replace(capacity_factor=factor)
    card_p = copy.deepcopy(cpu_p).to(cuda)
    a, aux_a, route_a = _moe_run(card_p, x.to(cuda), cfg)
    b, aux_b, _ = _moe_run(card_p, x.to(cuda), cfg)
    torch.cuda.synchronize()
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    want, aux_w, route_w = _moe_run(cpu_p, x, cfg)
    assert torch.equal(route_a[0], route_w[0])
    assert torch.equal(route_a[1], route_w[1])
    if factor == 0.5:
        assert not bool(route_w[1].all())          # some assignments drop
    err = ((a.cpu().float() - want.float()).abs()
           / want.float().abs().clamp_min(1.0)).max()
    assert float(err) <= 1e-2
    assert float(aux_a) == pytest.approx(float(aux_w), abs=1e-6)


def test_moe_products_keep_f32_on_card(cuda):
    """The grouped products of bf16 operands come back in f32 (`torch.bmm`
    with out_dtype=float32): equal to the f32 product of the widened
    operands within 1e-5 relative to max(|x|, 1), and not rounded to
    bf16."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(7)
    a = torch.randn(4, 33, 512, generator=g).bfloat16()
    w = torch.randn(4, 512, 256, generator=g).bfloat16() / 16
    for lhs, rhs in ((a, w), (a[0], w[0])):
        got = moe._mm_f32(lhs.to(cuda), rhs.to(cuda))
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        want = torch.matmul(lhs.float(), rhs.float())
        err = ((got.cpu() - want).abs() / want.abs().clamp_min(1.0)).max()
        assert float(err) <= 1e-5
        assert not torch.equal(got, got.bfloat16().float())


def test_moe_apply_f32_on_card_matches_cpu(cuda):
    """f32 (no TF32): the card's output within 1e-5 of the CPU's relative
    to max(|x|, 1), with the same routing."""
    import copy
    cfg, cpu_p, x = _moe_case("float32", seed=8)
    got, _, route_a = _moe_run(copy.deepcopy(cpu_p).to(cuda), x.to(cuda),
                               cfg)
    want, _, route_w = _moe_run(cpu_p, x, cfg)
    assert torch.equal(route_a[0], route_w[0])
    assert torch.equal(route_a[1], route_w[1])
    err = ((got.cpu() - want).abs() / want.abs().clamp_min(1.0)).max()
    assert float(err) <= 1e-5


def _moe_grads(p, x, cfg, ct):
    """moe_apply's gradient of the cotangent `ct` in x and in every
    parameter of the layer (router, expert stacks, shared expert), and
    its routing."""
    p.requires_grad_(True)
    try:
        xt = x.clone().requires_grad_()
        out, _, route = _moe_run(p, xt, cfg)
        names, leaves = zip(*p.named_parameters())
        grads = torch.autograd.grad(out, (xt,) + leaves, ct)
    finally:
        p.requires_grad_(False)
    return dict(zip(("x",) + names, grads)), route


@pytest.mark.parametrize("factor", [0.5, 1.25])
def test_moe_backward_bf16_on_card(cuda, factor):
    """The bf16 MoE backward on the card, through `MatmulF32` (the grouped
    and the shared expert's products) and `Dispatch`: two calls give the
    same bits, the routing equals the CPU's, and every gradient is within
    2e-2 relative L2 of the CPU's gradient of the same Functions (the same
    f32 sums in other orders, each rounded once to bf16; a rounding step
    in h's or x's gradient carries on, as tests/test_torch_moe_grad.py
    holds the CPU to the reference)."""
    import copy
    cfg, cpu_p, x = _moe_case("bfloat16", seed=9)
    cfg = cfg.replace(capacity_factor=factor)
    ct = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        10)).bfloat16()
    card_p = copy.deepcopy(cpu_p).to(cuda)
    a, route_a = _moe_grads(card_p, x.to(cuda), cfg, ct.to(cuda))
    b, _ = _moe_grads(card_p, x.to(cuda), cfg, ct.to(cuda))
    torch.cuda.synchronize()
    assert all(torch.equal(a[k], b[k]) for k in a)
    want, route_w = _moe_grads(cpu_p, x, cfg, ct)
    assert torch.equal(route_a[0], route_w[0])
    assert torch.equal(route_a[1], route_w[1])
    assert set(a) == set(want) and any(k.startswith("shared.") for k in a)
    for k, g in a.items():
        assert g.dtype == want[k].dtype == torch.bfloat16, k
        w = want[k].double()
        gap = float((g.cpu().double() - w).norm() / w.norm())
        assert gap <= 2e-2, (k, gap)


def test_sliced_adamw_on_card_is_bitwise_the_whole(cuda, monkeypatch):
    """AdamW on the card over a bf16 tensor of three slices (the constant
    patched to a third of it): parameters and moments after three steps
    equal the unsliced update's bit for bit."""
    from repro_torch.optim import adamw
    cfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10,
                            clip_norm=0.5)
    g = torch.Generator().manual_seed(11)
    p0 = {"w": torch.randn(3, 1000, 333, generator=g).bfloat16().to(cuda),
          "b": torch.randn(333, generator=g).to(cuda)}
    grads = [{k: torch.randn(v.shape, generator=g).to(cuda, v.dtype)
              for k, v in p0.items()} for _ in range(3)]
    out = {}
    for size in (1000 * 333, 1 << 26):
        monkeypatch.setattr(adamw, "_SLICE", size)
        params = {k: v.clone() for k, v in p0.items()}
        opt = adamw.init_opt_state(params, cfg)
        for gr in grads:
            params, opt, _ = adamw.adamw_update(params, gr, opt, cfg)
        out[size] = (params, opt)
    monkeypatch.setattr(adamw, "_SLICE", 1000 * 333)
    assert len(adamw._slices(p0["w"])) == 3
    (pa, oa), (pb, ob) = out.values()
    torch.cuda.synchronize()
    for k in p0:
        assert torch.equal(pa[k], pb[k]), k
        assert torch.equal(oa["m"][k], ob["m"][k]), k
        assert torch.equal(oa["v"][k], ob["v"][k]), k
    assert not torch.equal(pa["w"], p0["w"])


# --------------------------------------------------------------------------
# The attention backward and the train path on the card.  Tolerances per
# gradient, against max |grad|: f32 1e-4 max|g| + 1e-6 (the same f32
# products summed in another order), bf16 2e-2 max|g| (the bf16 forward
# rounds P and its output to bf16, which D = rowsum(dO O) and the
# recomputed P inherit; the bf16 backward rounds P and dS to bf16 before
# the products on the tensor cores, and each gradient to bf16 once;
# tests/test_torch_attention_bwd_bf16.py holds an emulation of that
# arithmetic to the same oracles on the CPU).  The
# oracle is float64 on the card: the plain blocked backward
# (ref.attention_bwd) on the same operands, and autograd through the plain
# forward.
# --------------------------------------------------------------------------
def _assert_grads_close(got, want, dtype):
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        scale = float(w.abs().max())
        tol = rel * scale + (1e-6 if dtype == torch.float32 else 0.0)
        err = float((g.double() - w.double()).abs().max())
        assert torch.isfinite(g).all() and err <= tol, (name, err, tol)


# (b, sq, skv, h, hkv, dh, dv)
BWD_SHAPES = [(2, 1024, 1024, 24, 2, 128, 128),    # starcoder2's train shape
              (1, 130, 130, 4, 4, 192, 128),       # MLA widths
              (1, 77, 200, 4, 2, 64, 64),          # Sq < Skv, ragged tiles
              (2, 100, 100, 6, 3, 40, 24),         # widths not a multiple of 8
              (1, 33, 33, 2, 2, 256, 256),         # the widest head
              (1, 1, 9, 2, 1, 16, 16),             # one query row
              (2, 1024, 1024, 32, 32, 96, 96),     # phi-3-vision's, MHA
              (1, 1024, 1024, 32, 32, 64, 64)]     # musicgen's, MHA


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_matches_plain(cuda, shape, causal, dtype):
    b, sq, skv, h, hkv, dh, dv = shape
    q = _attn_inputs(b, sq, skv, h, hkv, dh, dv, dtype, cuda)[0]
    _, k, v = _attn_inputs(b, skv, skv, h, hkv, dh, dv, dtype, cuda)
    dout = torch.randn(b, sq, h, dv, generator=torch.Generator(
        ).manual_seed(4)).to(dtype).to(cuda)
    out, lse = fa_kernel.flash_attention(q, k, v, causal=causal,
                                         return_lse=True)
    want_out, want_lse = ref.attention_lse(q.double(), k.double(),
                                           v.double(), causal=causal)
    assert float((lse.double() - want_lse).abs().max()) <= 1e-5
    got = fa_kernel.flash_attention_bwd(q, k, v, out, lse, dout,
                                        causal=causal)
    torch.cuda.synchronize()
    plain = ref.attention_bwd(*(t.double() for t in (q, k, v, out, lse,
                                                      dout)), causal=causal)
    _assert_grads_close(got, plain, dtype)
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(ref.attention(q64, k64, v64, causal=causal),
                               (q64, k64, v64), dout.double())
    _assert_grads_close(got, auto, dtype)


def test_flash_attention_bwd_is_deterministic(cuda):
    q, k, v = _attn_inputs(2, 300, 300, 8, 2, 64, 64, torch.bfloat16, cuda)
    dout = torch.randn_like(q)
    out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True)
    first = fa_kernel.flash_attention_bwd(q, k, v, out, lse, dout)
    for _ in range(3):
        again = fa_kernel.flash_attention_bwd(q, k, v, out, lse, dout)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# (b, sq, skv, h, hkv, dh, dv, G): the group split of the bf16 route's
# dk/dv kernel (G > 1: a fourth kernel reduces the partials) at each
# padded width instance the paths use, and 256
BWD_SPLIT_SHAPES = [
    (2, 1024, 1024, 24, 2, 128, 128, 6),   # starcoder2's train shape
    (2, 512, 1024, 24, 2, 128, 128, 6),    # Sq < Skv
    (1, 1024, 1024, 16, 16, 192, 128, 1),  # MLA widths, 32-row tiles
    (1, 300, 300, 8, 8, 80, 80, 1),        # zamba2's heads of 80, ragged
    (2, 300, 300, 8, 2, 128, 128, 4),      # a small grid: the whole group
    (1, 100, 150, 4, 1, 256, 256, 4),      # the widest head, split
    (1, 70, 70, 3, 1, 256, 200, 3),        # 256 over Dh != Dv, ragged
    (2, 1024, 1024, 32, 32, 96, 96, 1),    # phi-3-vision: MHA, no split
    (1, 1024, 1024, 32, 32, 64, 64, 1),    # musicgen: MHA, no split
    (2, 1024, 1024, 128, 128, 192, 128, 1),  # deepseek-v3's train shape
    (2, 1023, 1023, 128, 128, 192, 128, 1),  # its MTP layer's, S - 1
]


@pytest.mark.parametrize("dh,dv", [(64, 64), (96, 96), (96, 64),
                                   (128, 128), (192, 128)])
def test_flash_attention_bf16_occupancy(cuda, dh, dv):
    """The bf16 route's forward, dq and dk/dv kernels at each padded width:
    each launched with the shared memory its tile shapes give (the CUDA
    source's TcShape and BwdShape), and at least one block per SM."""
    d = (max(dh, dv) + 15) // 16 * 16
    rows = 32 if d > 128 else 64
    pitch = d + 8
    want = {"flash_attention_bf16_kernel": 2 * pitch * (64 + 4 * rows),
            "flash_attention_bwd_dq_tc": 2 * pitch * (2 * 64 + 4 * 32),
            "flash_attention_bwd_dkv_tc": 2 * pitch * (2 * rows + 4 * rows)
            + 4 * 4 * rows}
    got = fa_kernel.bf16_occupancy(dh, dv)
    assert {k: v["smem_bytes"] for k, v in got.items()} == want
    assert all(v["blocks_per_sm"] >= 1 for v in got.values()), got


@pytest.mark.parametrize("shape", BWD_SPLIT_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_flash_attention_bwd_bf16_splits_and_widths(cuda, shape):
    """The bf16 route against both f64 oracles (2e-2 max|g|), with G and
    the kernels per call each shape gives: the pre-pass, dq, dk/dv and,
    where G > 1, the reduction, each launched once."""
    b, sq, skv, h, hkv, dh, dv, splits = shape
    bf16 = torch.bfloat16
    q = _attn_inputs(b, sq, skv, h, hkv, dh, dv, bf16, cuda)[0]
    _, k, v = _attn_inputs(b, skv, skv, h, hkv, dh, dv, bf16, cuda, seed=1)
    dout = torch.randn(b, sq, h, dv, generator=torch.Generator(
        ).manual_seed(2)).to(bf16).to(cuda)
    out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True)
    assert fa_kernel.bwd_splits(q, k, v) == splits
    run = lambda: fa_kernel.flash_attention_bwd(q, k, v, out, lse, dout)
    got = run()
    torch.cuda.synchronize()
    plain = ref.attention_bwd(*(t.double() for t in (q, k, v, out, lse,
                                                      dout)))
    _assert_grads_close(got, plain, bf16)
    del plain
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(ref.attention(q64, k64, v64),
                               (q64, k64, v64), dout.double())
    _assert_grads_close(got, auto, bf16)
    names = ["_dot", "_dq_tc", "_dkv_tc"] + (["_reduce"] if splits > 1
                                             else [])
    calls = 2
    counts = _device_kernel_counts(run, calls, per_call=len(names))
    assert len(counts) == len(names), counts
    for n in names:
        assert [c for key, c in counts.items()
                if "flash_attention_bwd" + n in key] == [calls], (n, counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_takes_operands_offset_from_allocation(cuda,
                                                                   dtype):
    """Operands 2 elements into their allocations (rows not 16-byte
    aligned) take the element-by-element loads and stores, and give the
    aligned call's gradient bit for bit."""
    b, sq, skv, h, hkv, dh, dv = 1, 130, 130, 6, 2, 64, 64
    q, k, v = _attn_inputs(b, sq, skv, h, hkv, dh, dv, dtype, cuda)
    dout = torch.randn_like(q)

    def offset(t):
        buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=t.device)
        moved = buf[2:].view(t.shape)
        moved.copy_(t)
        assert moved.is_contiguous() and moved.data_ptr() % 16 != 0
        return moved

    out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True)
    want = fa_kernel.flash_attention_bwd(q, k, v, out, lse, dout)
    got = fa_kernel.flash_attention_bwd(*(offset(t) for t in (q, k, v, out)),
                                        lse, offset(dout))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    plain = ref.attention_bwd(*(t.double() for t in (q, k, v, out, lse,
                                                      dout)))
    _assert_grads_close(got, plain, dtype)


def test_flash_attention_bwd_split_path_is_deterministic(cuda):
    """starcoder2's train shape splits its group of 12 (G = 6): two calls
    give the same gradient bit for bit."""
    q, k, v = _attn_inputs(2, 1024, 1024, 24, 2, 128, 128, torch.bfloat16,
                           cuda)
    dout = torch.randn_like(q)
    out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True)
    assert fa_kernel.bwd_splits(q, k, v) > 1
    first = fa_kernel.flash_attention_bwd(q, k, v, out, lse, dout)
    again = fa_kernel.flash_attention_bwd(q, k, v, out, lse, dout)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


# (b, sq, skv, h, hkv, dh, dv, dtype, causal, lead): G > 1 and G = 1, the
# padded widths 80, 128, 192 and 256, ragged ends, Sq < Skv, both routes;
# `lead` elements of guard before each buffer (4098: rows not 16-byte
# aligned, the element-by-element loads)
BWD_GUARD_SHAPES = [
    (2, 1024, 1024, 24, 2, 128, 128, "bf16", True, 4096),
    (2, 512, 1024, 24, 2, 128, 128, "bf16", True, 4096),
    (1, 1024, 1024, 16, 16, 192, 128, "bf16", True, 4096),
    (1, 70, 70, 3, 1, 256, 200, "bf16", True, 4096),
    (1, 77, 200, 4, 2, 80, 80, "bf16", False, 4096),
    (2, 100, 100, 6, 3, 40, 24, "bf16", True, 4098),
    (1, 77, 200, 4, 2, 64, 64, "f32", True, 4096),
]


@pytest.mark.parametrize("shape", BWD_GUARD_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_flash_attention_bwd_stays_inside_its_buffers(cuda, shape):
    """Every operand, output and the scratch (sized by `bwd_scratch`) lies
    inside a larger buffer filled with NaN: the library's call leaves the
    guard bands untouched (no write outside an output or the scratch) and
    gives the wrapper's gradient bit for bit (every output element
    written, and no read outside an operand or an unwritten scratch
    element reached a result)."""
    b, sq, skv, h, hkv, dh, dv, name, causal, lead = shape
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[name]
    q = _attn_inputs(b, sq, skv, h, hkv, dh, dv, dtype, cuda)[0]
    _, k, v = _attn_inputs(b, skv, skv, h, hkv, dh, dv, dtype, cuda, seed=1)
    dout = torch.randn(b, sq, h, dv, generator=torch.Generator(
        ).manual_seed(2)).to(dtype).to(cuda)
    out, lse = fa_kernel.flash_attention(q, k, v, causal=causal,
                                         return_lse=True)
    bufs = []

    def guarded(shape_, dtype_, like=None):
        n = int(np.prod(shape_))
        buf = torch.full((lead + n + 4096,), float("nan"), dtype=dtype_,
                         device=cuda)
        inner = buf[lead:lead + n].view(shape_)
        if like is not None:
            inner.copy_(like)
        bufs.append((buf, n))
        return inner

    ops = [guarded(t.shape, t.dtype, t) for t in (q, k, v, out, dout, lse)]
    grads = [guarded(t.shape, dtype) for t in (q, k, v)]
    dd = guarded((fa_kernel.bwd_scratch(q, k, v),), torch.float32)
    err = fa_kernel.load().flash_attention_bwd(
        *(t.data_ptr() for t in ops + grads + [dd]), b, sq, skv, h, hkv,
        dh, dv, int(causal), fa_kernel.DTYPES[dtype],
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for buf, n in bufs:
        assert torch.isnan(buf[:lead]).all() and torch.isnan(
            buf[lead + n:]).all()
    want = fa_kernel.flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal)
    assert all(torch.equal(a, w) for a, w in zip(grads, want))


def test_flash_attention_lse_leaves_the_output_unchanged(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _attn_inputs(1, 200, 200, 4, 2, 80, 80, dtype, cuda)
        plain = fa_kernel.flash_attention(q, k, v)
        out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True)
        assert torch.equal(plain, out) and lse.shape == (1, 4, 200)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_ops_on_card_matches_plain(cuda, dtype):
    """`ops.flash_attention` under autograd on the card (the Function and
    the backward kernel) against autograd of the plain forward in f64."""
    from repro_torch.kernels import ops
    q, k, v = (t.requires_grad_() for t in _attn_inputs(
        2, 96, 96, 6, 2, 32, 32, dtype, cuda))
    fa_kernel.reset_launches()
    out = ops.flash_attention(q, k, v)
    dout = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert dict(fa_kernel.launches) == {"flash_attention": 1,
                                        "flash_attention_bwd": 1}
    q64, k64, v64 = (t.detach().double().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.attention(q64, k64, v64),
                               (q64, k64, v64), dout.double())
    _assert_grads_close(got, want, dtype)


def test_forward_without_a_gradient_saves_nothing(cuda):
    """Serving's forward (no grad recorded) launches the forward alone and
    returns an output with no graph."""
    from repro_torch.kernels import ops
    q, k, v = (t.requires_grad_() for t in _attn_inputs(
        1, 64, 64, 4, 2, 32, 32, torch.bfloat16, cuda))
    fa_kernel.reset_launches()
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    plain = ops.flash_attention(*(t.detach() for t in (q, k, v)))
    assert out.grad_fn is None and plain.grad_fn is None
    assert dict(fa_kernel.launches) == {"flash_attention": 2,
                                        "flash_attention_bwd": 0}


def test_flash_attention_bwd_rejects_bad_operands(cuda):
    q, k, v = _attn_inputs(1, 8, 8, 4, 2, 16, 16, torch.float32, cuda)
    out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        fa_kernel.flash_attention_bwd(q, k, v, out, lse[:, :2].contiguous(),
                                      out)
    with pytest.raises(ValueError, match="dout"):
        fa_kernel.flash_attention_bwd(q, k, v, out, lse, out.bfloat16())
    with pytest.raises(ValueError, match="out"):
        fa_kernel.flash_attention_bwd(q, k, v, out[:, :4].contiguous(), lse,
                                      out)


def test_ssd_and_wkv_refuse_a_gradient_on_card(cuda):
    """The raw wrappers return outputs with no grad_fn: under grad they
    raise, each naming its autograd Function (`Mamba2SSD`, `RWKV6WKV`),
    which `ops` takes.  So reduced zamba2 and rwkv6 differentiate on the
    card, through the backward kernels."""
    x, dt, a, bi, ci, d, _ = _ssd_inputs(1, 64, 2, 16, 16, torch.float32,
                                         cuda, False)
    with pytest.raises(NotImplementedError, match="Mamba2SSD"):
        ssd_kernel.mamba2_ssd(x.requires_grad_(), dt, a, bi, ci, d)
    with torch.no_grad():
        ssd_kernel.mamba2_ssd(x, dt, a, bi, ci, d)
    r, k, v, w, u, _ = _wkv_inputs(1, 64, 2, 16, 16, torch.float32, cuda,
                                   False)
    with pytest.raises(NotImplementedError, match="RWKV6WKV"):
        wkv_kernel.rwkv6_wkv(r, k, v, w, u.requires_grad_())
    from repro_torch import configs
    from repro_torch.models import model
    for arch in ("zamba2-2.7b", "rwkv6-3b"):
        cfg = configs.get_reduced(arch)
        m = model.init_params(cfg, 0, cuda).trainable()
        toks = torch.randint(0, cfg.vocab_size, (1, 16), device=cuda)
        ssd_kernel.reset_launches()
        wkv_kernel.reset_launches()
        loss, _ = model.loss_fn(m, {"tokens": toks}, cfg)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        assert all(torch.isfinite(g).all() for g in grads)
        bwd = (ssd_kernel.launches["mamba2_ssd_bwd"] if arch == "zamba2-2.7b"
               else wkv_kernel.launches["rwkv6_wkv_bwd"])
        assert bwd == cfg.n_layers, (arch, bwd)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_card_matches_cpu(cuda, remat):
    """One train step of reduced starcoder2 (f32) on the card and on the
    CPU from the same weights: loss and lr within 1e-5, the gradient no
    further from the f64 one than max(1e-5, 2 x the CPU's f32 error), the
    updated parameters within 2 lr + 1e-6 (AdamW's first step turns a
    gradient near 0 into +-lr).  With remat each layer's forward launches
    twice and its backward once."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
    cfg = configs.get_reduced("starcoder2-3b").replace(remat=remat)
    cpu = model.init_params(cfg, 5, "cpu").trainable()
    card = model.LM(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    card.trainable()
    c64 = cfg.replace(dtype="float64")
    m64 = model.LM(c64, "cpu")
    m64.load_state_dict({k: v.double() for k, v in cpu.state_dict().items()})
    m64.trainable()
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    grads, mets = {}, {}
    for name, m, c in (("card", card, cfg), ("cpu", cpu, cfg),
                       ("f64", m64, c64)):
        named = dict(m.named_parameters())
        fa_kernel.reset_launches()
        loss, _ = model.loss_fn(m, {"tokens": toks.to(
            next(m.parameters()).device)}, c)
        g = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        if name == "card":
            assert dict(fa_kernel.launches) == {
                "flash_attention": cfg.n_layers * (2 if remat else 1),
                "flash_attention_bwd": cfg.n_layers}
        grads[name] = {k: t.detach().cpu().double() for k, t in g.items()}
        _, _, met = adamw_update(named, g, init_opt_state(named,
                                                          AdamWConfig()),
                                 AdamWConfig())
        mets[name] = dict(loss=float(loss.detach()), lr=float(met["lr"]))
    g64 = grads.pop("f64")
    n64 = sum(float(t.square().sum()) for t in g64.values()) ** 0.5
    err = {n: sum(float((g[k] - g64[k]).square().sum()) for k in g64) ** 0.5
           / n64 for n, g in grads.items()}
    assert err["card"] <= max(1e-5, 2 * err["cpu"]), err
    for k in ("loss", "lr"):
        assert mets["card"][k] == pytest.approx(mets["cpu"][k], rel=1e-5)
    lr = mets["cpu"]["lr"]
    worst = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(card.parameters(), cpu.parameters()))
    assert worst <= 2 * lr + 1e-6


def test_remat_dots_step_on_card_matches_full(cuda):
    """starcoder2-3b at its published widths, 2 layers deep, f32, one
    loss and gradient through the attention kernels under remat "dots"
    (selective checkpointing: the products' outputs kept) against "full"
    and no remat: the kernel's forward reruns in the recompute under both
    policies (2 launches per layer, 1 backward), the gradients are equal
    bit for bit (the recompute runs the same kernels and cuBLAS calls on
    the same operands), and the peak memory of the forward, which holds
    what the policy keeps for the backward, lies under "dots" between
    "full"'s and no remat's.  (The step's own peak, with every gradient
    and the head's logits live, moves by under 0.2%: 1,988,326,400 bytes
    under "dots" and "full" and 1,990,425,088 with no remat on an H100.)"""
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get("starcoder2-3b").replace(n_layers=2, dtype="float32")
    m = model.init_params(cfg, 3, cuda).trainable()
    toks = torch.randint(0, cfg.vocab_size, (2, 512),
                         generator=torch.Generator().manual_seed(2))
    grads, peak = {}, {}
    for policy in ("none", "full", "dots"):
        c = (cfg.replace(remat=False) if policy == "none"
             else cfg.replace(remat=True, remat_policy=policy))
        fa_kernel.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # above what is held before the step (the earlier policies' grads)
        base = torch.cuda.memory_allocated()
        loss, _ = model.loss_fn(m, {"tokens": toks.to(cuda)}, c)
        torch.cuda.synchronize()
        peak[policy] = torch.cuda.max_memory_allocated() - base
        grads[policy] = torch.autograd.grad(loss, list(m.parameters()))
        assert dict(fa_kernel.launches) == {
            "flash_attention": cfg.n_layers * (1 if policy == "none" else 2),
            "flash_attention_bwd": cfg.n_layers}, policy
        del loss
    assert all(torch.equal(a, b) for a, b in zip(grads["dots"],
                                                 grads["full"]))
    assert all(torch.equal(a, b) for a, b in zip(grads["dots"],
                                                 grads["none"]))
    assert peak["full"] < peak["dots"] < peak["none"], peak


def _deepseek_step(m, cfg, toks):
    """Loss, metrics and every gradient of one `loss_fn` of a reduced
    deepseek-v3 (the MTP block's included), the attention launches it
    made, and each MoE layer's routing (idx, keep) on the host."""
    from repro_torch.models import model, moe
    named = dict(m.named_parameters())
    fa_kernel.reset_launches()
    seen = []
    with moe.observe(lambda idx, keep, cap: seen.append((idx.cpu(),
                                                         keep.cpu()))):
        loss, met = model.loss_fn(m, {"tokens": toks.to(
            next(m.parameters()).device)}, cfg)
        g = torch.autograd.grad(loss, list(named.values()))
    return (loss.detach(), {k: v.detach() for k, v in met.items()},
            dict(zip(named, g)), dict(fa_kernel.launches), seen)


def test_deepseek_bf16_train_step_is_bitwise_on_card(cuda):
    """Reduced deepseek-v3-671b in bf16 with remat "full" on the card
    (MLA through the attention kernels, the sigmoid router, the shared
    expert, the MTP block): the loss, its metrics and every gradient, the
    MTP block's included, are the same bits over two calls; each of the
    stack's layers launches the attention forward twice and its backward
    once, the MTP layer once each."""
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get_reduced("deepseek-v3-671b").replace(
        dtype="bfloat16", remat=True)
    m = model.init_params(cfg, 3, cuda).trainable()
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(3))
    first = _deepseek_step(m, cfg, toks)
    again = _deepseek_step(m, cfg, toks)
    torch.cuda.synchronize()
    loss, met, grads, launches, _ = first
    assert torch.isfinite(loss) and set(met) == {"ce", "aux", "mtp_ce",
                                                 "loss"}
    assert torch.equal(loss, again[0])
    assert all(torch.equal(v, again[1][k]) for k, v in met.items())
    assert set(grads) == set(again[2]) and any(k.startswith("mtp.")
                                               for k in grads)
    for k, g in grads.items():
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all(), k
        assert torch.equal(g, again[2][k]), k
    assert launches == again[3] == {
        "flash_attention": 2 * cfg.n_layers + 1,
        "flash_attention_bwd": cfg.n_layers + 1}


def test_deepseek_f32_train_step_on_card_matches_cpu(cuda):
    """One train step of reduced deepseek-v3-671b (f32, its MTP loss) on
    the card and on the CPU from the same weights, at the CPU tests'
    tolerances: the same routing; loss, ce, aux, the MTP cross-entropy and
    lr within 1e-5 relative; the gradient no further from the f64 one
    than max(1e-5, 2 x the CPU's f32 error); the updated parameters
    within 2 lr + 1e-6 (AdamW's first step turns a gradient near 0 into
    +-lr)."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
    cfg = configs.get_reduced("deepseek-v3-671b")
    cpu = model.init_params(cfg, 5, "cpu").trainable()
    card = model.LM(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    card.trainable()
    c64 = cfg.replace(dtype="float64")
    m64 = model.LM(c64, "cpu")
    m64.load_state_dict({k: v.double() for k, v in cpu.state_dict().items()})
    m64.trainable()
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    grads, mets, routes = {}, {}, {}
    for name, m, c in (("card", card, cfg), ("cpu", cpu, cfg),
                       ("f64", m64, c64)):
        _, met, g, launches, routes[name] = _deepseek_step(m, c, toks)
        if name == "card":
            assert launches == {"flash_attention": cfg.n_layers + 1,
                                "flash_attention_bwd": cfg.n_layers + 1}
        grads[name] = {k: t.cpu().double() for k, t in g.items()}
        named = dict(m.named_parameters())
        _, _, om = adamw_update(named, g, init_opt_state(named,
                                                         AdamWConfig()),
                                AdamWConfig())
        mets[name] = {k: float(v) for k, v in {**met, **om}.items()}
    for a, b in zip(routes["card"], routes["cpu"]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    g64 = grads.pop("f64")
    n64 = sum(float(t.square().sum()) for t in g64.values()) ** 0.5
    err = {n: sum(float((g[k] - g64[k]).square().sum()) for k in g64) ** 0.5
           / n64 for n, g in grads.items()}
    assert err["card"] <= max(1e-5, 2 * err["cpu"]), err
    for k in ("loss", "ce", "aux", "mtp_ce", "lr"):
        assert mets["card"][k] == pytest.approx(mets["cpu"][k], rel=1e-5), k
    lr = mets["cpu"]["lr"]
    worst = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(card.parameters(), cpu.parameters()))
    assert worst <= 2 * lr + 1e-6


# ---------------------------------------------------------------------------
# The Python twins of the backward kernels' library rules, which the dry run
# (repro_torch.launch.cost) reads on meta tensors, against the C functions
ATTN_TWIN_SHAPES = [
    # b, sq, skv, h, hkv, dh, dv: starcoder2, MLA, Sq < Skv, phi-3-vision,
    # musicgen, dbrx, deepseek and its MTP layer, zamba2's shared block, odd
    (2, 1024, 1024, 24, 2, 128, 128), (1, 1024, 1024, 16, 16, 192, 128),
    (2, 512, 1024, 24, 2, 128, 128), (2, 1024, 1024, 32, 32, 96, 96),
    (1, 1024, 1024, 32, 32, 64, 64), (2, 1024, 1024, 48, 8, 128, 128),
    (2, 1024, 1024, 128, 128, 192, 128), (2, 1023, 1023, 128, 128, 192, 128),
    (2, 1024, 1024, 32, 32, 80, 80), (256, 4096, 4096, 40, 8, 128, 128),
    (1, 1, 300, 6, 3, 256, 256), (3, 77, 77, 12, 4, 8, 24),
    (1, 64, 64, 8, 1, 16, 16), (4, 33, 65, 9, 3, 144, 112),
    (2, 16, 16, 5, 2, 32, 32)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ATTN_TWIN_SHAPES)
def test_flash_attention_bwd_twins_equal_the_library(cuda, shape, dtype):
    b, sq, skv, h, hkv, dh, dv = shape
    lib = fa_kernel.load()
    code = fa_kernel.DTYPES[dtype]
    assert fa_kernel.splits_rule(b, skv, h, hkv, dh, dv, dtype) == (
        lib.flash_attention_bwd_splits(b, skv, h, hkv, dh, dv, code))
    assert fa_kernel.scratch_floats(b, sq, skv, h, hkv, dh, dv, dtype) == (
        lib.flash_attention_bwd_scratch(b, sq, skv, h, hkv, dh, dv, code))


@pytest.mark.parametrize("shape", [
    # b, s, h, p, n (SSD) or b, s, h, k, v (WKV)
    (2, 1024, 80, 64, 64), (2, 777, 8, 16, 16), (1, 1, 3, 5, 7),
    (4, 65, 40, 64, 64), (2, 1024, 40, 64, 64), (1, 4096, 2, 32, 128)])
def test_ssd_and_wkv_bwd_scratch_twins_equal_the_library(cuda, shape):
    assert ssd_kernel.scratch_floats(*shape) == ssd_kernel.bwd_scratch(*shape)
    b, s, h, k, v = shape
    kv = (min(k, wkv_kernel.MAX_KV_BWD), min(v, wkv_kernel.MAX_KV_BWD))
    assert wkv_kernel.scratch_floats(b, s, h, *kv) == (
        wkv_kernel.bwd_scratch(b, s, h, *kv))
