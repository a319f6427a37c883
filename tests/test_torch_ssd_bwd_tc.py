"""The arithmetic of the CUDA SSD backward's bf16 route, emulated in plain
PyTorch on the CPU and held to the oracles the card holds the kernel to,
before any card runs it.

The bf16 route of `ssd_bwd_chunk_grad` (`mamba2_ssd_bwd` in
`src/repro_torch/kernels/csrc/mamba2_ssd.cu`) runs the chunk's eight
64 x 64 products on the tensor cores: bf16 operands, f32 sums.  Two of
them have bf16 operands on both sides (dy x^T and C B^T); a product of two
bf16 values is exact in f32, so they round nothing new.  The other six
each have one f32 operand: the chunk state S, the state's gradient G, and
the masked tiles M = C B^T o decay and Dm = (dy xdt^T) o decay.  The route
splits that operand into two bf16 pieces (hi = bf16(v), lo = bf16(v - hi),
together v to about 2^-16 of itself), multiplies each piece by the bf16
operand and sums the pieces' products in f32.  Everything else (the
decays, W, its prefix sums, r, v, q and the block sums) stays f32, as do
the state's gradient per chunk (another kernel) and the forward's chunk
states.  Each gradient is rounded once, to its operand's type.

`_emulate` computes that in plain PyTorch, over the kernel's 64-step
chunks, and the test holds it to `jax.vjp` of the reference's sequential
scan (`repro.kernels.ref.mamba2_ssd`) and to the port's plain backward
(`ref.mamba2_ssd_bwd`, f32 products) on the same numpy inputs, x, B, C
and dy rounded to bf16 as the card's route takes them.  Tolerance: the
card's, 1e-4 max|g| per gradient, plus 2^-8 max|g| for a gradient in bf16
(one rounding of the f32 result).  With one piece (the f32 operand simply
rounded to bf16) the f32 gradients miss it; that case is pinned below.
Every in-chunk decay is taken from a segment sum of the log decay, as the
kernel takes it; the strong-decay case from a zero state holds da to the
scan's gradient with it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

PIECES = 2            # kPieces in the CUDA source
CHUNK = 64            # kC in the CUDA source
REL = 1e-4
NAMES = ("dx", "ddt", "da", "db", "dc", "dd", "dstate")


def _pieces(v, k):
    """f32 v as k bf16 values (carried in f32), largest first: each is
    the bf16 rounding of what the earlier ones leave."""
    out = []
    for _ in range(k):
        hi = v.to(torch.bfloat16).float()
        out.append(hi)
        v = v - hi
    return out


def _mixed(eq, first, second, k, split):
    """einsum(eq, first, second) with operand `split` (0 or 1, f32) cut
    into k bf16 pieces and the other bf16-valued: each piece's products
    summed in f32, then the pieces' sums added."""
    ops = [first, second]
    total = None
    for piece in _pieces(ops[split], k):
        ops[split] = piece
        term = torch.einsum(eq, *ops)
        total = term if total is None else total + term
    return total


def _emulate(x, dt, a, b_in, c_in, d, state, dy, dso, k):
    """The bf16 route's gradient (dx, ddt, da, db, dc, dd, dstate) with
    the f32 operands of six products cut into k pieces; each gradient in
    its operand's type (dstate None when state is)."""
    bb, s, h, p = x.shape
    n = b_in.shape[-1]
    pad = (-s) % CHUNK
    nc = (s + pad) // CHUNK

    def chunks(t, *rest):
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(bb, nc, CHUNK, *rest)

    xf, dyf = chunks(x, h, p), chunks(dy, h, p)
    dtf = chunks(dt, h)
    bf, cf = chunks(b_in, n), chunks(c_in, n)
    af, df = a.float(), d.float()
    la = dtf * af
    cum = torch.cumsum(la, dim=2)
    clast = cum[:, :, -1]
    ecum = torch.exp(cum)
    dec = tref.segment_sums(la).exp()      # e^{cum_t - cum_j}, j <= t
    edec = dec[:, :, -1]

    # the forward's chunk states (its kernel takes e^{cum_L - cum_j} as the
    # difference of running sums) and the state's gradient per chunk: f32
    fwd_dec = torch.exp(clast[:, :, None] - cum)
    inc = torch.einsum("bcjh,bcjhp,bcjn->bchpn", fwd_dec * dtf, xf, bf)
    st = (torch.zeros((bb, h, p, n)) if state is None else state.float())
    states = []
    for c in range(nc):
        states.append(st)
        st = torch.exp(clast[:, c])[..., None, None] * st + inc[:, c]
    sc = torch.stack(states, 1)
    inc = torch.einsum("bcth,bcthp,bctn->bchpn", ecum, dyf, cf)
    g = torch.zeros((bb, h, p, n)) if dso is None else dso.float()
    grads = [None] * nc
    for c in reversed(range(nc)):
        grads[c] = g
        g = torch.exp(clast[:, c])[..., None, None] * g + inc[:, c]
    dstate = g
    gc = torch.stack(grads, 1)

    tri = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril()
    # the two products of bf16 operands: exact products, f32 sums
    cb = torch.einsum("bctn,bcjn->bctj", cf, bf)
    dxr = torch.einsum("bcthp,bcjhp->bctjh", dyf, xf)
    dd = torch.diagonal(dxr, dim1=2, dim2=3).sum((0, 1, 3))
    dxm = dxr * dtf[:, :, None]
    m = cb[..., None] * dec
    dm = dxm * dec
    w = cb[..., None] * dm
    # the six with one f32 operand, split
    u = _mixed("bcthp,bchpn->bcthn", dyf, sc, k, 1)              # S^T dy
    v = _mixed("bcjhp,bchpn->bcjhn", xf, gc, k, 1) * dtf[..., None]
    dc = (ecum[..., None] * u
          + _mixed("bctjh,bcjn->bcthn", dm, bf, k, 0)).sum(3)
    db = (_mixed("bctjh,bctn->bcjhn", dm, cf, k, 0)
          + edec[..., None] * v).sum(3)
    dxdt = (_mixed("bctjh,bcthp->bcjhp", m, dyf, k, 0)
            + edec[..., None] * _mixed("bcjn,bchpn->bcjhp", bf, gc, k, 1))
    # the decay's gradient, term by term, in f32
    r = ecum * torch.einsum("bctn,bcthn->bcth", cf, u)
    vj = edec * torch.einsum("bcjn,bcjhn->bcjh", bf, v)
    q = torch.exp(clast) * torch.einsum("bchpn,bchpn->bch", gc, sc)

    def before(t, dim):
        t = torch.cumsum(t, dim).narrow(dim, 0, CHUNK - 1)
        return torch.cat([torch.zeros_like(t.narrow(dim, 0, 1)), t], dim)

    dla = (torch.flip(torch.cumsum(torch.flip(r, (2,)), 2), (2,))
           + q[:, :, None] + before(vj, 2)
           + (before(w, 3) * tri[..., None]).sum(2))
    dx = dtf[..., None] * dxdt + df[:, None] * dyf
    ddt = af * dla + (dxdt * xf).sum(-1)
    da = (dtf * dla).sum((0, 1, 2))

    def unchunk(t, like):
        return t.reshape(bb, nc * CHUNK, *t.shape[3:])[:, :s].to(like.dtype)

    return (unchunk(dx, x), unchunk(ddt, dt), da, unchunk(db, b_in),
            unchunk(dc, c_in), dd.to(d.dtype),
            None if state is None else dstate)


def _inputs(b, s, h, p, n, a_scale, seed):
    """x, B, C, dy ~ N(0, 1) rounded to bf16 (the route's operand type),
    D too; dt = softplus(N(0, 1)); a = -a_scale exp(0.3 N(0, 1)); the
    state 0.1 N(0, 1) and the final state's gradient N(0, 1), f32."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        v = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(v).bfloat16().float().numpy()

    x = bf16(b, s, h, p)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-a_scale * np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    bi, ci, d = bf16(b, s, n), bf16(b, s, n), bf16(h)
    st = (0.1 * rng.standard_normal((b, h, p, n))).astype(np.float32)
    dy = bf16(b, s, h, p)
    dso = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a, bi, ci, d, st), dy, dso


def _run(case, k):
    """(emulated, jax.vjp of the scan, plain backward) for one case."""
    b, s, h, with_state, with_dso, a_scale = case
    args, dy, dso = _inputs(b, s, h, 64, 64, a_scale, seed=s + h)
    jargs = list(args)
    if not with_state:
        jargs[6] = np.zeros_like(args[6])
    _, vjp = jax.vjp(jref.mamba2_ssd, *jargs)
    want = vjp((jnp.asarray(dy),
                jnp.asarray(dso if with_dso else np.zeros_like(dso))))
    t = [torch.from_numpy(v) for v in args]
    for i in (0, 3, 4, 5):                 # x, B, C and D in bf16
        t[i] = t[i].bfloat16()
    st = t[6] if with_state else None
    dy16 = torch.from_numpy(dy).bfloat16()
    dso_t = torch.from_numpy(dso) if with_dso else None
    got = _emulate(*t[:6], st, dy16, dso_t, k)
    plain = tref.mamba2_ssd_bwd(*t[:6], st, dy16, dso_t)
    return got, want, plain


def _excess(got, want):
    """Per gradient, its largest error over its tolerance (<= 1 passes)."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        if g is None:
            continue
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w.float() if isinstance(w, torch.Tensor) else w,
                       np.float32)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.isfinite(g).all(), name
        rel = REL + (2 ** -8 if name in ("dx", "db", "dc", "dd") else 0.0)
        out[name] = float(np.abs(g - w).max()) / (rel * float(np.abs(w)
                                                           .max()))
    return out


# (b, s, h, with_state, with_dso, a_scale); P = N = 64, zamba2's widths
CASES = [
    (2, 150, 3, True, True, 1.0),      # B > 1, ragged S, a state
    (1, 100, 2, False, True, 1.0),     # no state
    (1, 130, 2, True, False, 1.0),     # no final state's gradient
    (1, 64, 3, False, False, 1.0),     # one chunk, neither
    (1, 200, 2, True, True, 8.0),      # strong decay: a chunk's log
                                       # decays sum to about -500
]
# strong decay from a zero state with no final state's gradient, as a
# training step gives it
ZERO_STATE_STRONG_DECAY = (2, 77, 2, False, False, 8.0)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("oracle", ["jax_vjp_of_scan", "plain_backward"])
def test_bf16_route_emulation_within_the_cards_tolerance(case, oracle):
    got, want, plain = _run(case, PIECES)
    excess = _excess(got, want if oracle == "jax_vjp_of_scan" else plain)
    assert max(excess.values()) <= 1.0, excess


def test_bf16_route_emulation_from_a_zero_state_under_strong_decay():
    """The training regime under a = -8: the emulation and the plain
    backward are each within the card's tolerance of the scan's gradient,
    da included, and of each other.  Both take every in-chunk decay
    e^{cum_t - cum_j} from the segment sum of the log decay over (j, t]:
    as the difference of two running sums near -500 (f32 spacing 3e-5) it
    put da, a sum of terms of both signs and small here, 1.6e-4 max|g|
    from the scan's."""
    got, want, plain = _run(ZERO_STATE_STRONG_DECAY, PIECES)
    assert max(_excess(got, plain).values()) <= 1.0
    emulated, chunked = _excess(got, want), _excess(plain, want)
    assert chunked["da"] <= 1.0, chunked
    assert emulated["da"] <= 1.0, emulated
    for name in ("dx", "ddt", "db", "dc", "dd"):
        assert emulated[name] <= 1.0, (name, emulated)
        assert chunked[name] <= 1.0, (name, chunked)


def _ssd_scan_f64(x, dt, a, b_in, c_in, d):
    """The SSD recurrence step by step in float64, from a zero state."""
    bb, s, h, p = x.shape
    st = np.zeros((bb, h, p, b_in.shape[-1]))
    x, dt, a, b_in, c_in, d = (np.asarray(v, np.float64)
                               for v in (x, dt, a, b_in, c_in, d))
    ys = []
    for t in range(s):
        st = (np.exp(dt[:, t] * a)[..., None, None] * st
              + np.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], b_in[:, t]))
        ys.append(np.einsum("bhpn,bn->bhp", st, c_in[:, t])
                  + d[None, :, None] * x[:, t])
    return np.stack(ys, 1), st


@pytest.mark.parametrize("chunk", [64, 256])
def test_forward_from_a_zero_state_under_strong_decay(chunk):
    """The forward in the same regime (a = -8, a zero state): the plain
    chunked forward and an emulation of the forward kernel's arithmetic
    (tests/test_torch_lm_kernels.py) hold y and the final state to the f64
    scan within the f32 forward's tolerance (2e-3 + 2e-3 |v|, the card's),
    and closer still: 1e-5 of max|y| and of max|state|.  So the forward's
    exponents, differences of running sums, stay as they are; the backward
    forms its own."""
    from test_torch_lm_kernels import _ssd_kernel_emulation
    b, s, h, _, _, a_scale = ZERO_STATE_STRONG_DECAY
    (x, dt, a, bi, ci, d, _), _, _ = _inputs(b, s, h, 64, 64, a_scale,
                                             seed=s + h)
    wy, wst = _ssd_scan_f64(x, dt, a, bi, ci, d)
    t = [torch.from_numpy(v) for v in (x, dt, a, bi, ci, d)]
    for y, st in (tref.mamba2_ssd(*t, None, chunk=chunk),
                  _ssd_kernel_emulation(*t, None)):
        y, st = y.double().numpy(), st.double().numpy()
        assert np.isfinite(y).all() and np.isfinite(st).all()
        assert (np.abs(y - wy) <= 2e-3 + 2e-3 * np.abs(wy)).all()
        assert (np.abs(st - wst) <= 2e-3 + 2e-3 * np.abs(wst)).all()
        assert np.abs(y - wy).max() <= 1e-5 * np.abs(wy).max()
        assert np.abs(st - wst).max() <= 1e-5 * np.abs(wst).max()


def test_one_piece_misses_the_tolerance():
    """The f32 operands rounded to bf16 once (no split): the f32
    gradient ddt misses 1e-4 max|g| several times over.  This is why
    the route splits them."""
    got, _, plain = _run(CASES[0], 1)
    assert _excess(got, plain)["ddt"] > 4.0
