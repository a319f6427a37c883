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
into four 16-step sub-blocks, every decay a product of max(w, 1e-30) over
the steps it spans, multiplied in step by step (no exponential), the terms
that take the state and its gradient apart, and the middle term of dla
split by the sub-blocks of its pairs.  It is held to the plain backward
and to `jax.vjp` of the scan, down to log w = -69 from a zero state, near
w = 1 and around the clamp.  With `pieces` it is the bf16 route's: the
state terms' products on the tensor cores take S, G and k o edec each in
two bf16 pieces (`_pieces` / `_mixed`); one piece misses the tolerance.
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


def _pieces(x, k):
    """f32 x as k bf16 values (carried in f32), largest first: each is the
    bf16 rounding of what the earlier ones leave (`kPieces` in the
    source)."""
    out = []
    for _ in range(k):
        hi = x.to(torch.bfloat16).float()
        out.append(hi)
        x = x - hi
    return out


def _mixed(eq, first, second, pieces, split):
    """einsum(eq, first, second) as the bf16 route's mma.sync takes it:
    operand `split` (0, 1, or None for both; f32) cut into bf16 pieces,
    the other bf16-valued; each pair of pieces whose indices sum below
    `pieces` multiplied in f32 sums, then the products added."""
    a = _pieces(first, pieces) if split in (0, None) else [first]
    b = _pieces(second, pieces) if split in (1, None) else [second]
    total = None
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            if i + j < pieces:
                term = torch.einsum(eq, x, y)
                total = term if total is None else total + term
    return total


def _emulate_kernel(r, k, v, w, u, state, do, dso, pieces=None):
    """The CUDA backward's arithmetic in plain f32 (shapes and returns as
    `ref.rwkv6_wkv_bwd`), over 64-step chunks cut into four 16-step
    sub-blocks; with `pieces`, the bf16 route's, whose state terms'
    products take S, G and k o edec in that many bf16 pieces each.  No exponential: every decay is a product of p = max(w,
    1e-30) over its own steps, multiplied in step by step.  Per (step,
    channel): elcp (the product over the steps of its sub-block before
    it) and ers (after it); per sub-block: et (its product).  Off-diagonal
    pairs t in I > j in J take elcp_t D_IJ ers_j, D_IJ the product of et
    between; inside one sub-block each (j, channel) carries its product
    along t (A and dk), each (t, channel) along j downwards (dr).  The
    terms that take the state S and its gradient G come apart, as phase 3
    computes them; the middle term of dla splits into (a) t after and j
    before i's sub-block, (b) t after and j in it, (c) t in it and j
    before, (d) both in it, carried along i as W_t(i+1) = p_{i+1} (W_t(i)
    + (do_t.v_i) k_i)."""
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    pad = (-s) % CHUNK
    nc = (s + pad) // CHUNK
    nb = CHUNK // SUB

    def chunks(t, value=0.0):                    # -> [B, H, NC, L, E]
        t = F.pad(t.float(), (0, 0, 0, 0, 0, pad), value=value)
        return t.reshape(b, nc, CHUNK, h, t.shape[-1]).permute(0, 3, 1, 2, 4)

    rf, kf, vf, dof = chunks(r), chunks(k), chunks(v), chunks(do)
    p = torch.clamp_min(chunks(w, 1.0), 1e-30)
    uf = u.float()[None, :, None, None, :]
    blk = [t // SUB for t in range(CHUNK)]

    # running products inside each sub-block, exclusive, step by step
    pb = p.reshape(b, h, nc, nb, SUB, kd)
    ones = torch.ones_like(pb[..., :1, :])
    elcp = torch.cat([ones, torch.cumprod(pb, 4)[..., :-1, :]], 4)
    ers = torch.cat([ones, torch.cumprod(pb.flip(4), 4)[..., :-1, :]],
                    4).flip(4)
    et = torch.cumprod(pb, 4)[..., -1, :]       # [B, H, NC, 4, K]
    elcp, ers = elcp.reshape(p.shape), ers.reshape(p.shape)

    def prod(m0, m1):
        out = torch.ones(b, h, nc, kd)
        for m in range(m0, m1):
            out = out * et[:, :, :, m]
        return out

    ecp = elcp * torch.stack([prod(0, blk[t]) for t in range(CHUNK)], 3)
    edec = ers * torch.stack([prod(blk[t] + 1, nb) for t in range(CHUNK)], 3)
    plast = prod(0, nb)
    dpair = {(i, j): prod(j + 1, i) for i in range(nb) for j in range(i)}

    # phases 1 and 2: the chunk states (the forward's) and the reverse scan
    st = torch.zeros(b, h, kd, vd) if state is None else state.float()
    sc = []
    for c in range(nc):
        sc.append(st)
        st = plast[:, :, c, :, None] * st + torch.einsum(
            "bhjk,bhjv->bhkv", kf[:, :, c] * edec[:, :, c], vf[:, :, c])
    sc = torch.stack(sc, 2)
    inc = torch.einsum("bhcjk,bhcjv->bhckv", rf * ecp, dof)
    g = torch.zeros(b, h, kd, vd) if dso is None else dso.float()
    gc = [None] * nc
    for c in reversed(range(nc)):
        gc[c] = g
        g = plast[:, :, c, :, None] * g + inc[:, :, c]
    gc = torch.stack(gc, 2)

    # phase 3: the terms that take S and G (on the bf16 route S, G and k o
    # edec in pieces; do and v are bf16-valued)
    if pieces is None:
        dr_s = ecp * torch.einsum("bhckv,bhctv->bhctk", sc, dof)
        dk_s = edec * torch.einsum("bhckv,bhcjv->bhcjk", gc, vf)
        dv_s = torch.einsum("bhckv,bhcjk->bhcjv", gc, kf * edec)
    else:
        dr_s = ecp * _mixed("bhckv,bhctv->bhctk", sc, dof, pieces, 0)
        dk_s = edec * _mixed("bhckv,bhcjv->bhcjk", gc, vf, pieces, 0)
        dv_s = _mixed("bhckv,bhcjk->bhcjv", gc, kf * edec, pieces, None)
    q = plast * (sc * gc).sum(-1)

    # phase 4
    dov = torch.einsum("bhctv,bhcjv->bhctj", dof, vf)
    bonus = torch.diagonal(dov, dim1=-2, dim2=-1)[..., None]
    rt, kt = rf * elcp, kf * ers
    a = torch.zeros(b, h, nc, CHUNK, CHUNK)
    for (i, j), dp in dpair.items():
        ri, rj = slice(SUB * i, SUB * i + SUB), slice(SUB * j, SUB * j + SUB)
        a[..., ri, rj] = torch.einsum("bhctk,bhcjk->bhctj",
                                      rt[:, :, :, ri] * dp[:, :, :, None],
                                      kt[:, :, :, rj])
    dgk, ersk = torch.zeros_like(kf), torch.ones_like(kf)
    dgr, elcpr = torch.zeros_like(rf), torch.ones_like(rf)
    for m in range(nb):
        for jl in range(SUB):           # (j, channel) carried along t
            j, e = SUB * m + jl, torch.ones(b, h, nc, kd)
            for tl in range(jl + 1, SUB):
                t = SUB * m + tl
                re = rf[:, :, :, t] * e
                a[..., t, j] = (re * kf[:, :, :, j]).sum(-1)
                dgk[:, :, :, j] += dov[..., t, j, None] * re
                e = e * p[:, :, :, t]
            ersk[:, :, :, j] = e
        for tl in range(SUB):           # (t, channel) carried down j
            t, e = SUB * m + tl, torch.ones(b, h, nc, kd)
            for jl in reversed(range(tl)):
                j = SUB * m + jl
                dgr[:, :, :, t] += dov[..., t, j, None] * kf[:, :, :, j] * e
                e = e * p[:, :, :, j]
            elcpr[:, :, :, t] = e
    a = a + torch.diag_embed((rf * uf * kf).sum(-1))
    dv = torch.einsum("bhctj,bhctv->bhcjv", a, dof) + dv_s
    xo, yo = torch.zeros_like(kf), torch.zeros_like(rf)
    for (i, j), dp in dpair.items():
        ri, rj = slice(SUB * i, SUB * i + SUB), slice(SUB * j, SUB * j + SUB)
        blkd = dov[..., ri, rj]
        xo[:, :, :, rj] += dp[:, :, :, None] * torch.einsum(
            "bhctj,bhctk->bhcjk", blkd, rt[:, :, :, ri])
        yo[:, :, :, ri] += dp[:, :, :, None] * torch.einsum(
            "bhctj,bhcjk->bhctk", blkd, kt[:, :, :, rj])
    dk = ersk * xo + dgk + bonus * uf * rf + dk_s
    dr = elcpr * yo + dgr + bonus * uf * kf + dr_s
    du = torch.einsum("bhctx,bhctk->hk", bonus, rf * kf)
    x, z, pbt, pct = rf * dr_s, kf * dk_s, kt * xo, rt * yo
    qpair = {(i, j): torch.einsum(
        "bhctk,bhctj,bhcjk->bhck", rt[:, :, :, SUB * i:SUB * i + SUB],
        dov[..., SUB * i:SUB * i + SUB, SUB * j:SUB * j + SUB],
        kt[:, :, :, SUB * j:SUB * j + SUB])
        for (i, j) in dpair if i >= j + 2}
    dla = torch.zeros_like(p)
    for m in range(nb):
        i0 = SUB * m
        pa = sum((dpair[pr] * qq for pr, qq in qpair.items()
                  if pr[0] > m > pr[1]), torch.zeros(b, h, nc, kd))
        wt = [torch.zeros(b, h, nc, kd) for _ in range(SUB)]
        for n in range(SUB):
            i = i0 + n
            dd, bt = torch.zeros(b, h, nc, kd), torch.ones(b, h, nc, kd)
            for tl in range(n + 1, SUB):             # (d)
                dd = dd + rf[:, :, :, i0 + tl] * bt * wt[tl]
                bt = bt * p[:, :, :, i0 + tl]
            dla[:, :, :, i] = (x[:, :, :, i + 1:].sum(3)
                               + pct[:, :, :, i + 1:i0 + SUB].sum(3)
                               + z[:, :, :, :i].sum(3)
                               + pbt[:, :, :, i0:i].sum(3) + q + pa + dd)
            for tl in range(n + 2, SUB):
                wt[tl] = (wt[tl] + dov[..., i0 + tl, i, None]
                          * kf[:, :, :, i]) * p[:, :, :, i + 1]

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
    (1, 130, 2, 8, 8, False, False, -1.5),   # zero state, strong decay
    (1, 70, 2, 8, 8, True, True, -1e-3),     # w near 1
])
def test_kernel_emulation_matches_plain_backward(case):
    b, s, h, kd, vd, with_state, with_dso, log_w = case
    args, do, dso = _inputs(b, s, h, kd, vd, log_w=log_w, seed=31)
    got = _port(args, do, dso, with_state, with_dso, fn=_emulate_kernel)
    want = _port(args, do, dso, with_state, with_dso)
    excess = _excess(got, want, args[3])
    assert max(excess.values()) <= 1.0, excess


def _around_clamp(w, seed):
    """w with a third of its entries moved to 10^U(-31, -29): on both
    sides of the clamp at 1e-30."""
    rng = np.random.default_rng(seed)
    near = 10.0 ** rng.uniform(-31.0, -29.0, w.shape)
    return np.where(rng.random(w.shape) < 1 / 3, near, w).astype(np.float32)


# (b, s, h, k, v, with_state, with_dso, log_w, around the clamp)
EMULATION_CASES = [
    (1, 200, 2, 8, 8, False, False, -69.0, False),   # zero state, strong
    (1, 200, 2, 8, 8, False, False, -1.5, False),    # decay, no dstate_out
    (2, 100, 2, 8, 8, True, True, -1e-3, False),     # w near 1
    (1, 150, 2, 8, 8, True, True, None, True),       # w around 1e-30
    (1, 70, 1, 64, 64, False, False, -1.5, False),   # rwkv6-3b's head
]


@pytest.mark.parametrize("case", EMULATION_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_kernel_emulation_matches_jax_vjp_and_plain(case):
    """The kernel's arithmetic (decays as running products of the clamped
    w) against `jax.vjp` of the reference's sequential scan and against
    the plain backward, at the same limits: from a zero state under a
    strong decay with no final state's gradient (as a training step calls
    it), with w near 1, and with w on both sides of the clamp (where dw is
    0 below it, the gradient of a clamped forward; compared as w o dw, the
    reference's unclamped gradient there is below the tolerance)."""
    b, s, h, kd, vd, with_state, with_dso, log_w, clamp = case
    args, do, dso = _inputs(b, s, h, kd, vd, log_w=log_w, seed=37)
    if clamp:
        args = list(args)
        args[3] = _around_clamp(args[3], 41)
    got = _port(args, do, dso, with_state, with_dso, fn=_emulate_kernel)
    if clamp:
        below = torch.from_numpy(args[3] < 1e-30)
        assert bool(below.any()) and (got[3][below] == 0).all()
    w_cmp = np.maximum(args[3], 1e-30)
    for want in (_jax_want(args, do, dso, with_state, with_dso),
                 _port(args, do, dso, with_state, with_dso)):
        excess = _excess(got, want, w_cmp)
        assert max(excess.values()) <= 1.0, excess


PIECES = 2            # kPieces in the CUDA source
# (b, s, h, k, v, with_state, with_dso, log_w)
BF16_CASES = [
    (1, 130, 2, 16, 16, False, False, None),   # a training step's call
    (2, 100, 2, 8, 8, True, True, None),       # state, final state's grad
    (1, 130, 2, 16, 16, False, False, -1.5),   # zero state, strong decay
]


def _bf16_route(case, pieces):
    """The bf16 route's emulation with `pieces`, and the two oracles, on
    bf16-rounded operands (r, k, v, u, do) carried in f32."""
    b, s, h, kd, vd, with_state, with_dso, log_w = case
    args, do, dso = _inputs(b, s, h, kd, vd, log_w=log_w, seed=43)
    args = list(args)
    for i in (0, 1, 2, 4):
        args[i] = torch.from_numpy(args[i]).to(torch.bfloat16).float().numpy()
    do = torch.from_numpy(do).to(torch.bfloat16).float().numpy()
    t = [torch.from_numpy(x) for x in args]
    bf = [x.to(torch.bfloat16) if i in (0, 1, 2, 4) else x
          for i, x in enumerate(t)]
    got = _emulate_kernel(*bf[:5], bf[5] if with_state else None,
                          torch.from_numpy(do).to(torch.bfloat16),
                          torch.from_numpy(dso) if with_dso else None,
                          pieces=pieces)
    return (got, _jax_want(args, do, dso, with_state, with_dso),
            _port(args, do, dso, with_state, with_dso), args[3])


@pytest.mark.parametrize("case", BF16_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_bf16_route_emulation_within_the_cards_tolerance(case):
    """The bf16 route (the state terms' products on the tensor cores with
    S, G and k o edec in two bf16 pieces, do.v exact, dr, dk, dv and du
    rounded once) against `jax.vjp` of the reference's scan and against
    the plain backward, at the card's tolerance for bf16 operands."""
    got, want, plain, w = _bf16_route(case, PIECES)
    for oracle in (want, plain):
        excess = _excess(got, oracle, w, bf16=True)
        assert max(excess.values()) <= 1.0, excess


def test_bf16_route_one_piece_misses_the_tolerance():
    """S, G and k o edec rounded to bf16 once (no split): dw, an f32
    gradient held to 1e-4 of its max, misses it several times over.  This
    is why the route splits them."""
    got, _, plain, w = _bf16_route(BF16_CASES[0], 1)
    assert _excess(got, plain, w, bf16=True)["dw"] > 4.0
