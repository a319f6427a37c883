"""The plain version of the WKV backward (`repro_torch.kernels.ref.
rwkv6_wkv_bwd`) and the CUDA kernel's decomposition of it, against the
reference, on the CPU.

The reference has no backward of its own for the WKV: XLA differentiates
whatever the forward is.  Its sequential scan (`repro.kernels.ref.
rwkv6_wkv`) differentiates cleanly, so `jax.vjp` of the scan, with the
final state's gradient included, is the oracle here; the chunked form
(`rwkv6_wkv_chunked`) is NaN at log w = -1.5 (tests/test_torch_rwkv.py).
The same numpy inputs and output gradients go through both.  Under a
strong decay (log w down to -69 a step) the oracle is autograd of the
port's sequential recurrence (`ref.rwkv6_wkv_scan`) in f64; the clamp of
w at 1e-30 is held to autograd of the port's plain forward, which takes
the same clamp.

Tolerance: 1e-4 of max|g| per gradient in f32; for bf16 operands (r, k, v,
u and the output gradient, as a bf16 model gives them) 1e-4 + 2^-8 of
max|g| for a gradient in bf16, which rounds the f32 result once.  dw is
compared as w o dw, the log decay's gradient: dw itself spans w's 30
decades.

`_emulate_kernel` is the CUDA kernel's arithmetic (`rwkv6_wkv_bwd` in
`src/repro_torch/kernels/csrc/rwkv6_wkv.cu`) in plain f32: each chunk cut
into four 16-step sub-blocks, every decay a product of exponentials of
sums over the steps it spans, and the middle term of dla split by the
sub-blocks of its pairs.  It is held to the plain backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

REL = 1e-4
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")
CHUNK = 64            # kC in the CUDA source
SUB = 16              # kL in the CUDA source: the sub-block


def _inputs(b, s, h, kd, vd, *, log_w=None, seed=3):
    """r, k, v, u, do, dstate_out ~ N(0, 1); w = exp(-exp(N(0, 0.5) - 1))
    (log w in about [-1, -0.1], as at random init) or exp(U(log_w, 0));
    the state 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, s, h, kd)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, vd)).astype(np.float32)
    if log_w is None:
        w = np.exp(-np.exp(0.5 * rng.standard_normal((b, s, h, kd)) - 1.0))
    else:
        w = np.exp(rng.uniform(log_w, 0.0, (b, s, h, kd)))
    u = rng.standard_normal((h, kd)).astype(np.float32)
    st = (0.1 * rng.standard_normal((b, h, kd, vd))).astype(np.float32)
    do = rng.standard_normal((b, s, h, vd)).astype(np.float32)
    dso = rng.standard_normal((b, h, kd, vd)).astype(np.float32)
    return (r, k, v, w.astype(np.float32), u, st), do, dso


def _excess(got, want, w, bf16=False):
    """Per gradient, its largest error over its tolerance (<= 1 passes)."""
    out = {}
    for name, g, x in zip(NAMES, got, want):
        if g is None:
            continue
        g = (g.double().numpy() if isinstance(g, torch.Tensor)
             else np.asarray(g, np.float64))
        x = (x.double().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x, np.float64))
        assert g.shape == x.shape, (name, g.shape, x.shape)
        assert np.isfinite(g).all(), name
        if name == "dw":
            g, x = g * w, x * w
        rel = REL + (2 ** -8 if bf16 and name in ("dr", "dk", "dv", "du")
                     else 0.0)
        out[name] = float(np.abs(g - x).max()) / (rel * float(np.abs(x)
                                                           .max()))
    return out


def _jax_want(args, do, dso, with_state, with_dso):
    jargs = list(args)
    if not with_state:
        jargs[5] = np.zeros_like(args[5])   # the reference's own default
    _, vjp = jax.vjp(jref.rwkv6_wkv, *jargs)
    want = vjp((jnp.asarray(do),
                jnp.asarray(dso if with_dso else np.zeros_like(dso))))
    return list(want[:5]) + [want[5] if with_state else None]


def _port(args, do, dso, with_state, with_dso, fn=tref.rwkv6_wkv_bwd):
    t = [torch.from_numpy(v) for v in args]
    return fn(*t[:5], t[5] if with_state else None, torch.from_numpy(do),
              torch.from_numpy(dso) if with_dso else None)


# (b, s, h, k, v, with_state, with_dso)
CASES = [
    (2, 150, 3, 16, 16, True, True),    # B > 1, H > 1, ragged S
    (1, 100, 2, 8, 12, False, True),    # no state; K != V
    (1, 130, 2, 16, 8, True, False),    # no final state's gradient
    (1, 64, 3, 16, 16, False, False),   # exactly one chunk, neither
    (2, 1, 2, 8, 8, True, True),        # one step
    (1, 70, 2, 64, 64, True, True),     # rwkv6-3b's head width
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_jax_vjp_of_the_scan(case):
    b, s, h, kd, vd, with_state, with_dso = case
    args, do, dso = _inputs(b, s, h, kd, vd, seed=s + h)
    got = _port(args, do, dso, with_state, with_dso)
    assert (got[5] is None) == (not with_state)
    excess = _excess(got, _jax_want(args, do, dso, with_state, with_dso),
                     args[3])
    assert max(excess.values()) <= 1.0, excess


@pytest.mark.parametrize("log_w", [-5.0, -69.0])
def test_plain_backward_under_strong_decay(log_w):
    """log w uniform down to log_w a step: a chunk's log decays sum to
    about 32 log_w, far below where exp(-cum) overflows.  Every exponent
    is a sum over its own steps, so the gradient is finite and equals
    autograd of the sequential recurrence in f64."""
    args, do, dso = _inputs(1, 200, 2, 16, 16, log_w=log_w, seed=17)
    got = _port(args, do, dso, True, True)
    leaves = [torch.from_numpy(v).double().requires_grad_() for v in args]
    out, fin = tref.rwkv6_wkv_scan(*leaves)
    want = torch.autograd.grad((out, fin), leaves,
                               (torch.from_numpy(do).double(),
                                torch.from_numpy(dso).double()))
    excess = _excess(got, want, args[3])
    assert max(excess.values()) <= 1.0, excess


def test_plain_backward_strong_decay_matches_jax_vjp():
    """The same regime against the JAX scan's gradient in f32."""
    args, do, dso = _inputs(2, 100, 2, 8, 8, log_w=-69.0, seed=19)
    got = _port(args, do, dso, True, True)
    excess = _excess(got, _jax_want(args, do, dso, True, True), args[3])
    assert max(excess.values()) <= 1.0, excess


def test_plain_backward_clamps_w_at_1e30():
    """w below 1e-30 (a tenth of the steps, some exactly 0) decays as
    1e-30, and its gradient is 0, as autograd of the port's plain forward
    (`log(clamp_min(w, 1e-30))`) gives it; every other gradient equal."""
    args, do, dso = _inputs(1, 90, 2, 8, 8, seed=23)
    args = list(args)
    rng = np.random.default_rng(5)
    small = rng.random(args[3].shape) < 0.1
    args[3] = np.where(small, np.where(rng.random(args[3].shape) < 0.5,
                                       0.0, 1e-35), args[3]).astype(
                                           np.float32)
    got = _port(args, do, dso, True, True)
    leaves = [torch.from_numpy(v).requires_grad_() for v in args]
    out, fin = tref.rwkv6_wkv(*leaves)
    want = torch.autograd.grad((out, fin), leaves,
                               (torch.from_numpy(do), torch.from_numpy(dso)))
    assert (got[3][torch.from_numpy(small)] == 0).all()
    excess = _excess(got, want, np.maximum(args[3], 1e-30))
    assert max(excess.values()) <= 1.0, excess


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(chunk, with_state):
    """The same gradient as torch autograd through `ref.rwkv6_wkv`, at
    other chunk lengths of the forward (the backward's own is 64)."""
    args, do, dso = _inputs(2, 150, 3, 8, 8, seed=6)
    leaves = [torch.from_numpy(v).requires_grad_() for v in args]
    state = leaves[5] if with_state else None
    out, fin = tref.rwkv6_wkv(*leaves[:5], state, chunk=chunk)
    want = torch.autograd.grad(
        (out, fin), leaves[:5] + ([state] if with_state else []),
        (torch.from_numpy(do), torch.from_numpy(dso)))
    got = _port(args, do, dso, with_state, True)
    excess = _excess(got, list(want) + ([] if with_state else [None]),
                     args[3])
    assert max(excess.values()) <= 1.0, excess


def test_plain_backward_bf16_operands():
    """bf16 r, k, v, u and output gradient (as a bf16 model gives them):
    each gradient in its operand's type (dw and dstate f32), within 1e-4
    max|g| of the JAX scan's gradient on the same rounded values, plus
    one rounding of the result for the bf16 ones."""
    args, do, dso = _inputs(2, 130, 2, 16, 16, seed=29)
    bf = torch.bfloat16
    t = [torch.from_numpy(v) for v in args]
    for i in (0, 1, 2, 4):
        t[i] = t[i].to(bf)
    do16 = torch.from_numpy(do).to(bf)
    got = tref.rwkv6_wkv_bwd(*t, do16, torch.from_numpy(dso))
    for g, op in zip(got, t):
        assert g.dtype == op.dtype
    rounded = [x.float().numpy() for x in t]
    want = _jax_want(rounded, do16.float().numpy(), dso, True, True)
    excess = _excess(got, want, args[3], bf16=True)
    assert max(excess.values()) <= 1.0, excess


def _emulate_kernel(r, k, v, w, u, state, do, dso):
    """The CUDA backward's arithmetic in plain f32, over 64-step chunks cut
    into four 16-step sub-blocks (shapes and returns as
    `ref.rwkv6_wkv_bwd`).  Per (step, channel): e^{lcp} (the sum over the
    steps of its sub-block before it) and e^{rs} (after it); per
    sub-block: e^{T} (its total); off-diagonal pairs t in I > j in J take
    e^{lcp_t} D_IJ e^{rs_j}, D_IJ the product of e^{T} between; pairs in
    one sub-block sum their exponent step by step.  The middle term of dla
    splits into (a) t after and j before i's sub-block, (b) t after and j
    in it, (c) t in it and j before, (d) both in it, pivoted at i."""
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    pad = (-s) % CHUNK
    nc = (s + pad) // CHUNK
    nb = CHUNK // SUB

    def chunks(t, value=0.0):                    # -> [B, H, NC, L, E]
        t = F.pad(t.float(), (0, 0, 0, 0, 0, pad), value=value)
        return t.reshape(b, nc, CHUNK, h, t.shape[-1]).permute(0, 3, 1, 2, 4)

    rf, kf, vf, dof = chunks(r), chunks(k), chunks(v), chunks(do)
    la = torch.log(torch.clamp_min(chunks(w, 1.0), 1e-30))
    uf = u.float()[None, :, None, None, :]
    lab = la.reshape(b, h, nc, nb, SUB, kd)
    elcp = tref._before(lab, 4).reshape(la.shape).exp()
    ers = tref._after(lab, 4).reshape(la.shape).exp()
    et = lab.sum(4).exp()                        # [B, H, NC, 4, K]
    blk = [t // SUB for t in range(CHUNK)]

    def prod(m0, m1):
        out = torch.ones(b, h, nc, kd)
        for m in range(m0, m1):
            out = out * et[:, :, :, m]
        return out

    ecp = elcp * torch.stack([prod(0, blk[t]) for t in range(CHUNK)], 3)
    edec = ers * torch.stack([prod(blk[t] + 1, nb) for t in range(CHUNK)], 3)
    ecl = prod(0, nb)
    dpair = {(i, j): prod(j + 1, i) for i in range(nb) for j in range(i)}

    def span(lo, hi):        # e^{sum_{lo <= n < hi} la_n}, step by step
        x = torch.zeros(b, h, nc, kd)
        for n in range(lo, hi):
            x = x + la[:, :, :, n]
        return x.exp()

    st = torch.zeros(b, h, kd, vd) if state is None else state.float()
    sc = []
    for c in range(nc):
        sc.append(st)
        st = ecl[:, :, c, :, None] * st + torch.einsum(
            "bhjk,bhjv->bhkv", kf[:, :, c] * edec[:, :, c], vf[:, :, c])
    sc = torch.stack(sc, 2)
    inc = torch.einsum("bhcjk,bhcjv->bhckv", rf * ecp, dof)
    g = torch.zeros(b, h, kd, vd) if dso is None else dso.float()
    gc = [None] * nc
    for c in reversed(range(nc)):
        gc[c] = g
        g = ecl[:, :, c, :, None] * g + inc[:, :, c]
    gc = torch.stack(gc, 2)

    dov = torch.einsum("bhctv,bhcjv->bhctj", dof, vf)
    rp, kp = rf * elcp, kf * ers
    a = torch.zeros(b, h, nc, CHUNK, CHUNK)
    xo, yo = torch.zeros_like(kf), torch.zeros_like(rf)
    dgr, dgk = torch.zeros_like(rf), torch.zeros_like(kf)
    for t in range(CHUNK):
        for j in range(t):
            if blk[t] != blk[j]:
                dp = dpair[(blk[t], blk[j])]
                a[..., t, j] = (rp[:, :, :, t] * dp * kp[:, :, :, j]).sum(-1)
                xo[:, :, :, j] += dov[..., t, j, None] * rp[:, :, :, t] * dp
                yo[:, :, :, t] += dov[..., t, j, None] * kp[:, :, :, j] * dp
            else:
                e = span(j + 1, t)
                a[..., t, j] = (rf[:, :, :, t] * kf[:, :, :, j] * e).sum(-1)
                dgr[:, :, :, t] += dov[..., t, j, None] * kf[:, :, :, j] * e
                dgk[:, :, :, j] += dov[..., t, j, None] * rf[:, :, :, t] * e
    bonus = torch.diagonal(dov, dim1=-2, dim2=-1)[..., None]
    a = a + torch.diag_embed((rf * uf * kf).sum(-1))
    sdo = torch.einsum("bhckv,bhctv->bhctk", sc, dof)
    gv = torch.einsum("bhckv,bhcjv->bhcjk", gc, vf)
    dr = ecp * sdo + elcp * yo + dgr + bonus * uf * kf
    dk = ers * xo + dgk + bonus * uf * rf + edec * gv
    dv = (torch.einsum("bhctj,bhctv->bhcjv", a, dof)
          + torch.einsum("bhckv,bhcjk->bhcjv", gc, kf * edec))
    du = torch.einsum("bhctx,bhctk->hk", bonus, rf * kf)
    x, z = rf * ecp * sdo, kf * edec * gv
    q = ecl * (sc * gc).sum(-1)
    pb, pc = kp * xo, rp * yo
    qpair = {(i, j): torch.einsum(
        "bhctk,bhctj,bhcjk->bhck", rp[:, :, :, SUB * i:SUB * i + SUB],
        dov[..., SUB * i:SUB * i + SUB, SUB * j:SUB * j + SUB],
        kp[:, :, :, SUB * j:SUB * j + SUB])
        for (i, j) in dpair if i >= j + 2}
    dla = torch.zeros_like(la)
    for i in range(CHUNK):
        m, i0 = blk[i], SUB * blk[i]
        acc = (x[:, :, :, i + 1:].sum(3) + z[:, :, :, :i].sum(3) + q
               + sum((dpair[p] * qq for p, qq in qpair.items()
                      if p[0] > m > p[1]), torch.zeros(b, h, nc, kd))
               + pb[:, :, :, i0:i].sum(3) + pc[:, :, :, i + 1:i0 + SUB].sum(3))
        for t in range(i + 1, i0 + SUB):
            inner = sum((dov[..., t, j, None] * kf[:, :, :, j]
                         * span(j + 1, i + 1) for j in range(i0, i)),
                        torch.zeros(b, h, nc, kd))
            acc = acc + rf[:, :, :, t] * span(i + 1, t) * inner
        dla[:, :, :, i] = acc

    def unchunk(t):
        return t.permute(0, 2, 3, 1, 4).reshape(b, nc * CHUNK, h,
                                                t.shape[-1])[:, :s]
    dlaf, wf = unchunk(dla), w.float()
    dw = torch.where(wf >= 1e-30, dlaf / wf, torch.zeros_like(dlaf))
    return (unchunk(dr).to(r.dtype), unchunk(dk).to(k.dtype),
            unchunk(dv).to(v.dtype), dw, du.to(u.dtype),
            None if state is None else g)


@pytest.mark.parametrize("case", [
    (1, 150, 2, 8, 8, True, True, None),     # ragged S, three chunks
    (2, 64, 1, 4, 4, False, False, None),    # one chunk, B = 2
    (1, 100, 1, 4, 4, True, True, -69.0),    # strong decay
])
def test_kernel_emulation_matches_plain_backward(case):
    b, s, h, kd, vd, with_state, with_dso, log_w = case
    args, do, dso = _inputs(b, s, h, kd, vd, log_w=log_w, seed=31)
    got = _port(args, do, dso, with_state, with_dso, fn=_emulate_kernel)
    want = _port(args, do, dso, with_state, with_dso)
    excess = _excess(got, want, args[3])
    assert max(excess.values()) <= 1.0, excess
