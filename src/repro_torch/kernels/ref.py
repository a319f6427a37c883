"""Plain PyTorch versions of the kernels (`repro/kernels/ref.py`).

These are the reference the CUDA kernels (`gp_kernel`, `flash_attention`,
`mamba2_ssd`, `rwkv6_wkv`) are held against on the card, and what the
dispatcher runs for tensors on the CPU.  The formulas follow the JAX
reference line for line (for the GP: norms minus twice the cross term,
clamped at 0), so that both round alike.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# ==========================================================================
# Attention
# ==========================================================================
def _acc(t: torch.Tensor) -> torch.dtype:
    """The type the plain versions compute in: f32, or f64 for f64
    operands (an oracle on the card)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scores(q, k, causal: bool):
    """[B,H,Sq,Skv] scaled scores in the compute type, masked at -1e30,
    and the mask (None without `causal`); k already has H heads."""
    sq, sk = q.shape[1], k.shape[1]
    acc = _acc(q)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc),
                          k.to(acc)) / math.sqrt(q.shape[-1])
    if not causal:
        return scores, None
    mask = torch.ones(sq, sk, dtype=torch.bool,
                      device=q.device).tril(diagonal=sk - sq)
    return scores.masked_fill(~mask, -1e30), mask


def _expand_kv(q, k, v):
    h, hkv = q.shape[2], k.shape[2]
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    return k, v


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: [B,Sq,H,Dh]; k: [B,Skv,Hkv,Dh]; v: [B,Skv,Hkv,Dv] -> [B,Sq,H,Dv]
    in q's dtype, computed in f32 (f64 for f64 operands).  The causal
    mask's diagonal is offset by Skv - Sq; masked scores are -1e30, as in
    the reference."""
    k, v = _expand_kv(q, k, v)
    scores, _ = _scores(q, k, causal)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype))
    return out.to(q.dtype)


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(`attention(q, k, v)`, lse [B,H,Sq]): each row's log-sum-exp of the
    scaled scores in the compute type, as the reference's
    `_flash_fwd_impl` returns it for its backward."""
    ke, _ = _expand_kv(q, k, v)
    scores, _ = _scores(q, ke, causal)
    return attention(q, k, v, causal=causal), torch.logsumexp(scores, -1)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  *, causal: bool = True, q_block: int = 512,
                  kv_block: int = 512
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward kernel: the reference's blocked
    custom VJP (`repro/kernels/ref.py:142-198`, `_flash_bwd`) in torch.
    D = rowsum(dO * O); for each (query block, key block), P = exp(S -
    lse) with masked pairs 0 and dS = P (dO V^T - D); dq sums dS K over
    the key blocks in order, dk and dv sum dS^T Q and P^T dO over the
    query blocks in order; all in f32 (f64 for f64 operands).  The kv
    heads' gradients sum their query heads'.  Returns (dq, dk, dv) in
    the operands' types."""
    b, sq, h, d = q.shape
    skv, hkv, dv_dim = k.shape[1], k.shape[2], v.shape[3]
    acc = _acc(q)
    ke, ve = (t.to(acc) for t in _expand_kv(q, k, v))
    qf, do, lse = q.to(acc), dout.to(acc), lse.to(acc)
    scale = 1.0 / math.sqrt(d)
    off = skv - sq
    dd = (do * out.to(acc)).sum(-1)                           # [B,Sq,H]
    dq = torch.zeros((b, sq, h, d), dtype=acc, device=q.device)
    dk = torch.zeros((b, skv, h, d), dtype=acc, device=q.device)
    dvv = torch.zeros((b, skv, h, dv_dim), dtype=acc, device=q.device)
    for q0 in range(0, sq, q_block):
        qs = slice(q0, min(q0 + q_block, sq))
        qpos = torch.arange(qs.start, qs.stop, device=q.device) + off
        for k0 in range(0, skv, kv_block):
            ks = slice(k0, min(k0 + kv_block, skv))
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, qs], ke[:, ks]) * scale
            p = torch.exp(s - lse[:, :, qs, None])
            if causal:
                kpos = torch.arange(ks.start, ks.stop, device=q.device)
                p = p.masked_fill(kpos[None, :] > qpos[:, None], 0.0)
            dp = torch.einsum("bqhd,bkhd->bhqk", do[:, qs], ve[:, ks])
            ds = p * (dp - dd[:, qs].transpose(1, 2)[..., None])
            dq[:, qs] += torch.einsum("bhqk,bkhd->bqhd", ds, ke[:, ks]) * scale
            dk[:, ks] += torch.einsum("bhqk,bqhd->bkhd", ds, qf[:, qs]) * scale
            dvv[:, ks] += torch.einsum("bhqk,bqhd->bkhd", p, do[:, qs])
    rep = h // hkv
    dk = dk.view(b, skv, hkv, rep, d).sum(3)
    dvv = dvv.view(b, skv, hkv, rep, dv_dim).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


# ==========================================================================
# Mamba2 SSD — scalar per-head decay.
#   state_t = exp(dt_t * A_h) state_{t-1} + dt_t * B_t x_t^T
#   y_t     = C_t . state_t + D_h * x_t
# ==========================================================================
def mamba2_ssd_scan(x, dt, a, b_in, c_in, d,
                    state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence, one step at a time: the oracle.
    x: [B,S,H,P]; dt: [B,S,H]; a: [H] (negative); b, c: [B,S,N]; d: [H];
    state: [B,H,P,N].  Returns (y [B,S,H,P] in x's dtype, final state
    f32)."""
    bb, s, h, p = x.shape
    n = b_in.shape[-1]
    st = (torch.zeros((bb, h, p, n), dtype=torch.float32, device=x.device)
          if state is None else state.float())
    xf, dtf = x.float(), dt.float()
    af, bf, cf, df = (t.float() for t in (a, b_in, c_in, d))
    ys = []
    for t in range(s):
        dtt = dtf[:, t]                                        # [B,H]
        dec = torch.exp(dtt * af[None])
        dbx = torch.einsum("bh,bhp,bn->bhpn", dtt, xf[:, t], bf[:, t])
        st = dec[..., None, None] * st + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", st, cf[:, t])
                  + df[None, :, None] * xf[:, t])
    return torch.stack(ys, 1).to(x.dtype), st


def mamba2_ssd(x, dt, a, b_in, c_in, d, state: Optional[torch.Tensor] = None,
               *, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (the Mamba2 state-space-dual form), the plain version
    of the kernel.  Shapes as `mamba2_ssd_scan`.  The intra-chunk decay
    exp(cum_t - cum_j) is taken only where j <= t: above the diagonal the
    exponent is positive and overflows at long chunks, and the reference's
    `exp(...) * tril` then gives inf * 0 = NaN."""
    bb, s, h, p = x.shape
    n = b_in.shape[-1]
    st = (torch.zeros((bb, h, p, n), dtype=torch.float32, device=x.device)
          if state is None else state.float())
    pad = (-s) % chunk
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    bf = F.pad(b_in.float(), (0, 0, 0, pad))
    cf = F.pad(c_in.float(), (0, 0, 0, pad))
    af, df = a.float(), d.float()
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    ys = []
    for c0 in range(0, s + pad, chunk):
        xc, dtc = xf[:, c0:c0 + chunk], dtf[:, c0:c0 + chunk]
        bc, cc = bf[:, c0:c0 + chunk], cf[:, c0:c0 + chunk]
        cum = torch.cumsum(dtc * af, dim=1)                    # [B,C,H]
        # inter: y_t += exp(cum_t) * (C_t . st)
        y_in = torch.einsum("btn,bhpn->bthp", cc, st) * torch.exp(cum)[..., None]
        # intra: y_t += sum_{j<=t} (C_t . B_j) exp(cum_t - cum_j) dt_j x_j
        g = torch.einsum("btn,bjn->btj", cc, bc)               # [B,C,C]
        ratio = cum[:, :, None, :] - cum[:, None, :, :]        # [B,C,C,H]
        l_mat = torch.where(tri, ratio, -math.inf).exp()
        xdt = dtc[..., None] * xc                              # [B,C,H,P]
        y_intra = torch.einsum("btjh,bjhp->bthp", g[..., None] * l_mat, xdt)
        # state: st' = exp(cum_C) st + sum_j exp(cum_C - cum_j) xdt_j B_j^T
        k_dec = torch.exp(cum[:, -1:] - cum)                   # [B,C,H]
        st = (torch.exp(cum[:, -1])[..., None, None] * st
              + torch.einsum("bjhp,bjn->bhpn", k_dec[..., None] * xdt, bc))
        ys.append(y_in + y_intra + df[None, None, :, None] * xc)
    return torch.cat(ys, 1)[:, :s].to(x.dtype), st


SSD_BWD_CHUNK = 64        # the backward kernel's chunk (kC in the source)


def segment_sums(la: torch.Tensor) -> torch.Tensor:
    """la [B, NC, L, *rest], a log decay per step of each chunk ->
    [B, NC, L(t), L(j), *rest]: seg(t, j) = sum_{j<k<=t} la_k where j <= t
    (0 on the diagonal), -inf above it.  Each is a sum of its own terms, so
    it holds to the precision of its own size: the difference cum_t - cum_j
    of two running sums carries their rounding, which under a strong decay
    (sums near -500) is larger than the smaller gradients it feeds."""
    ln = la.shape[2]
    idx = torch.arange(ln, device=la.device)
    shape = (ln, ln) + (1,) * (la.dim() - 3)
    after = (idx[:, None] > idx[None, :]).view(shape)          # [k, j]: k > j
    seg = torch.cumsum(la.unsqueeze(3) * after, dim=2)         # over k -> t
    return seg.masked_fill(~(idx[:, None] >= idx[None, :]).view(shape),
                           -math.inf)


def _after(t: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_{i>j} t_i along `dim` (exclusive), each a sum of its own terms."""
    n = t.shape[dim]
    rev = torch.flip(torch.cumsum(torch.flip(t, (dim,)), dim), (dim,))
    return torch.cat([rev.narrow(dim, 1, n - 1),
                      torch.zeros_like(rev.narrow(dim, 0, 1))], dim)


def _before(t: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_{i<j} t_i along `dim` (exclusive), each a sum of its own terms."""
    n = t.shape[dim]
    fwd = torch.cumsum(t, dim)
    return torch.cat([torch.zeros_like(fwd.narrow(dim, 0, 1)),
                      fwd.narrow(dim, 0, n - 1)], dim)


def mamba2_ssd_bwd(x, dt, a, b_in, c_in, d,
                   state: Optional[torch.Tensor], dy: torch.Tensor,
                   dstate_out: Optional[torch.Tensor]):
    """The plain version of the backward kernel: the gradient of
    `mamba2_ssd(x, dt, a, b_in, c_in, d, state)` for the output gradients
    dy ([B,S,H,P]) and dstate_out ([B,H,P,N], or None for zeros).
    Returns (dx, ddt, da, db, dc, dd, dstate), each in its operand's type
    (dstate None when state is None), all summed in f32 (f64 for f64
    operands).

    The kernel's chunked algorithm, over 64-step chunks.  Per (b, h) and
    chunk c, with cum_t the in-chunk running sum of dt a, xdt_j = dt_j x_j,
    S_c the state entering chunk c and G_c the gradient of the state
    leaving it:
      G_{NC-1} = dstate_out,  G_{c-1} = exp(cum_L) G_c
                              + sum_t exp(cum_t) dy_t C_t^T,  dstate = G_{-1};
      dxdt_j = sum_{t>=j} (C_t.B_j) e^{cum_t-cum_j} dy_t + e^{cum_L-cum_j} G B_j
      dC_t = e^{cum_t} S^T dy_t + sum_{j<=t} e^{cum_t-cum_j} (dy_t.xdt_j) B_j
      dB_j = sum_{t>=j} e^{cum_t-cum_j} (dy_t.xdt_j) C_t
             + e^{cum_L-cum_j} G^T xdt_j
    and the gradient of the log decay dt a, summed term by term (below).
    Every exponent taken is <= 0, and each in-chunk one, e^{cum_t-cum_j}
    and e^{cum_L-cum_j}, is taken from the segment sum of the log decay
    over (j, t] (`segment_sums`), not from the difference of two running
    sums."""
    acc = _acc(x)
    bb, s, h, p = x.shape
    n = b_in.shape[-1]
    ln = SSD_BWD_CHUNK
    pad = (-s) % ln
    nc = (s + pad) // ln

    def chunks(t, *rest):
        t = F.pad(t.to(acc), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(bb, nc, ln, *rest)

    xf, dyf = chunks(x, h, p), chunks(dy, h, p)               # [B,NC,L,H,P]
    dtf = chunks(dt, h)                                       # [B,NC,L,H]
    bf, cf = chunks(b_in, n), chunks(c_in, n)                 # [B,NC,L,N]
    af, df = a.to(acc), d.to(acc)
    la = dtf * af
    cum = torch.cumsum(la, dim=2)
    clast = cum[:, :, -1]                                     # [B,NC,H]
    ecum = torch.exp(cum)                                     # e^{cum_t}
    dec = segment_sums(la).exp()                      # e^{cum_t-cum_j}, j <= t
    edec = dec[:, :, -1]                                      # e^{cum_L-cum_j}
    xdt = dtf[..., None] * xf

    # the chunk states S_c (the kernel reads the forward's), then the
    # reverse scan of the state's gradient
    inc = torch.einsum("bcjh,bcjhp,bcjn->bchpn", edec, xdt, bf)
    st = (torch.zeros((bb, h, p, n), dtype=acc, device=x.device)
          if state is None else state.to(acc))
    states = []
    for c in range(nc):
        states.append(st)
        st = torch.exp(clast[:, c])[..., None, None] * st + inc[:, c]
    sc = torch.stack(states, 1)                               # [B,NC,H,P,N]
    inc = torch.einsum("bcth,bcthp,bctn->bchpn", ecum, dyf, cf)
    g = (torch.zeros((bb, h, p, n), dtype=acc, device=x.device)
         if dstate_out is None else dstate_out.to(acc))
    grads = [None] * nc
    for c in reversed(range(nc)):
        grads[c] = g
        g = torch.exp(clast[:, c])[..., None, None] * g + inc[:, c]
    dstate = g
    gc = torch.stack(grads, 1)                                # [B,NC,H,P,N]

    # in-chunk: [t, j] pairs, the decay taken only where j <= t
    tri = torch.ones(ln, ln, dtype=torch.bool, device=x.device).tril()
    cb = torch.einsum("bctn,bcjn->bctj", cf, bf)
    dxr = torch.einsum("bcthp,bcjhp->bctjh", dyf, xf)         # dy_t . x_j
    dd = torch.diagonal(dxr, dim1=2, dim2=3).sum((0, 1, 3))   # sum dy.x
    dxm = dxr * dtf[:, :, None]                               # dy_t . xdt_j
    m = cb[..., None] * dec
    dm = dxm * dec
    w = m * dxm
    u = torch.einsum("bcthp,bchpn->bcthn", dyf, sc)           # S^T dy_t
    v = torch.einsum("bcjhp,bchpn->bcjhn", xdt, gc)           # G^T xdt_j
    dc = (ecum[..., None] * u
          + torch.einsum("bctjh,bcjn->bcthn", dm, bf)).sum(3)
    db = (torch.einsum("bctjh,bctn->bcjhn", dm, cf)
          + edec[..., None] * v).sum(3)
    # the gradient of the log decay la_i = dt_i a, term by term: r_t (the
    # readout) reaches every i <= t, v_j (the state's input) every i > j,
    # q (the carried state) every i, and w[t, j] every j < i <= t.  Summed
    # so, no two large terms cancel: through the gradient of cum, the
    # diagonal w[t, t] would enter with both signs and swamp what is left
    # under a strong decay.
    r = ecum * torch.einsum("bctn,bcthn->bcth", cf, u)
    vj = edec * torch.einsum("bcjn,bcjhn->bcjh", bf, v)
    q = torch.exp(clast) * torch.einsum("bchpn,bchpn->bch", gc, sc)

    dla = (torch.flip(torch.cumsum(torch.flip(r, (2,)), 2), (2,))
           + q[:, :, None] + _before(vj, 2)
           + (_before(w, 3) * tri[..., None]).sum(2))
    dxdt = (torch.einsum("bctjh,bcthp->bcjhp", m, dyf)
            + edec[..., None] * torch.einsum("bcjn,bchpn->bcjhp", bf, gc))
    dx = dtf[..., None] * dxdt + df[:, None] * dyf
    ddt = af * dla + (dxdt * xf).sum(-1)
    da = (dtf * dla).sum((0, 1, 2))

    def unchunk(t, like):
        return t.reshape(bb, nc * ln, *t.shape[3:])[:, :s].to(like.dtype)

    return (unchunk(dx, x), unchunk(ddt, dt), da.to(a.dtype),
            unchunk(db, b_in), unchunk(dc, c_in), dd.to(d.dtype),
            None if state is None else dstate.to(state.dtype))


# ==========================================================================
# RWKV6 (Finch) WKV recurrence — data-dependent per-channel decay.
#   state_t = diag(w_t) state_{t-1} + k_t v_t^T
#   out_t   = r_t^T (state_{t-1} + diag(u * k_t) v_t^T)
# ==========================================================================
def rwkv6_wkv_scan(r, k, v, w, u, state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence, one step at a time: the oracle.
    r, k, w: [B,S,H,K]; v: [B,S,H,V]; u: [H,K]; state: [B,H,K,V].
    Returns (out [B,S,H,V] in r's dtype, final state f32)."""
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    st = (torch.zeros((b, h, kd, vd), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()
    outs = []
    for t in range(s):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        kv = kt[..., :, None] * vt[..., None, :]               # [B,H,K,V]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt,
                                 st + uf[..., :, None] * kv))
        st = wt[..., :, None] * st + kv
    return torch.stack(outs, 1).to(r.dtype), st


def rwkv6_wkv(r, k, v, w, u, state: Optional[torch.Tensor] = None, *,
              chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked gated-linear-attention form of the WKV6 recurrence, the
    plain version of the kernel.  Shapes as `rwkv6_wkv_scan`.

    The decays are taken relatively: exp(cum_{t-1} - cum_j) only where
    j < t, and exp(cum_C - cum_j) for the state, so every exponent is
    <= 0 and the result is finite for every w in (0, 1].  The reference's
    `rwkv6_wkv_chunked` factors them as exp(cum_{t-1}) exp(-cum_j), and
    exp(-cum_j) overflows once the log-decays of one chunk sum below
    about -88.  The bonus is summed with the rest in f32 and the output
    rounded to r's dtype once."""
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    st = (torch.zeros((b, h, kd, vd), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    pad = (-s) % chunk
    rf, kf, vf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
    wf = F.pad(w.float(), (0, 0, 0, 0, 0, pad), value=1.0)
    uf = u.float()
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=r.device).tril(-1)[None, :, :, None, None]
    outs = []
    for c0 in range(0, s + pad, chunk):
        rc, kc = rf[:, c0:c0 + chunk], kf[:, c0:c0 + chunk]   # [B,C,H,K]
        vc, wc = vf[:, c0:c0 + chunk], wf[:, c0:c0 + chunk]
        cum = torch.cumsum(torch.log(torch.clamp_min(wc, 1e-30)), dim=1)
        cum_prev = F.pad(cum[:, :-1], (0, 0, 0, 0, 1, 0))      # cum_{t-1}
        # inter: r_t . (prod_{i<t} w_i) state
        out = torch.einsum("bthk,bhkv->bthv", rc * torch.exp(cum_prev), st)
        # intra: A[t,j] = sum_k r_t k_j exp(cum_{t-1} - cum_j), j < t
        dec = torch.where(tri, cum_prev[:, :, None] - cum[:, None], -math.inf)
        a = torch.einsum("bthk,bjhk,btjhk->bhtj", rc, kc, dec.exp())
        out = out + torch.einsum("bhtj,bjhv->bthv", a, vc)
        # diagonal bonus: r_t . (u * k_t) v_t
        diag = torch.einsum("bthk,hk,bthk->bth", rc, uf, kc)
        outs.append(out + diag[..., None] * vc)
        # state: st' = exp(cum_C) st + sum_j (k_j exp(cum_C - cum_j)) v_j^T
        k_out = kc * torch.exp(cum[:, -1:] - cum)
        st = (torch.exp(cum[:, -1])[..., None] * st
              + torch.einsum("bjhk,bjhv->bhkv", k_out, vc))
    return torch.cat(outs, 1)[:, :s].to(r.dtype), st


WKV_BWD_CHUNK = 64        # the backward kernel's chunk (kC in the source)


def rwkv6_wkv_bwd(r, k, v, w, u, state: Optional[torch.Tensor],
                  do: torch.Tensor, dstate_out: Optional[torch.Tensor]):
    """The plain version of the backward kernel: the gradient of
    `rwkv6_wkv(r, k, v, w, u, state)` for the output gradients do
    ([B,S,H,V]) and dstate_out ([B,H,K,V], or None for zeros).  Returns
    (dr, dk, dv, dw, du, dstate), each in its operand's type (dstate None
    when state is None), all summed in f32 (f64 for f64 operands).

    The kernel's chunked algorithm, over 64-step chunks.  Per (b, h) and
    chunk, with c_t the in-chunk running sum of la = log max(w, 1e-30)
    (c_{-1} = 0, L the last step), S the state entering the chunk and G the
    gradient of the state leaving it:
      G_{c-1} = e^{c_L} o G_c + sum_t (r_t o e^{c_{t-1}}) do_t^T,
      dstate = G_{-1};
      dr_t = e^{c_{t-1}} o (S do_t) + sum_{j<t} (do_t.v_j) k_j o e^{c_{t-1}-c_j}
             + (do_t.v_t) u o k_t
      dk_j = sum_{t>j} (do_t.v_j) r_t o e^{c_{t-1}-c_j} + (do_j.v_j) u o r_j
             + e^{c_L-c_j} o (G v_j)
      dv_j = sum_{t>j} A_tj do_t + beta_j do_j + G^T (k_j o e^{c_L-c_j}),
             A_tj = sum_k r_t k_j e^{c_{t-1}-c_j},  beta_j = sum_k r_j u k_j
      du = sum_{b,t} (do_t.v_t) r_t o k_t
      dla_i = sum_{t>i} x_t + sum_{j<i<t} y_tj + q + sum_{j<i} z_j,
             x_t = r_t o e^{c_{t-1}} o (S do_t),
             y_tj = (do_t.v_j) r_t o k_j o e^{c_{t-1}-c_j},
             z_j = k_j o e^{c_L-c_j} o (G v_j),  q = e^{c_L} o rowsum(S o G)
      dw = dla / w where w >= 1e-30, else 0.
    dla, the gradient of the log decay, is summed term by term: as a
    reverse cumulative sum of the gradient of c, y_{t,t-1} (decay e^0)
    would enter it with both signs.  Every exponent taken is <= 0 and is
    summed from the log decays of its own steps (`segment_sums`), never
    the difference of two running sums: log w runs down to -69 a step."""
    acc = _acc(r)
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    ln = WKV_BWD_CHUNK
    pad = (-s) % ln
    nc = (s + pad) // ln

    def chunks(t, value=0.0):
        t = F.pad(t.to(acc), (0, 0, 0, 0, 0, pad), value=value)
        return t.reshape(b, nc, ln, h, t.shape[-1])

    rf, kf, vf, dof = chunks(r), chunks(k), chunks(v), chunks(do)
    wf = chunks(w, 1.0)
    la = torch.log(torch.clamp_min(wf, 1e-30))                # [B,NC,L,H,K]
    cprev = _before(la, 2)                                    # c_{t-1}
    ecl = torch.exp(la.sum(2))                                # e^{c_L} [B,NC,H,K]
    edec = torch.exp(_after(la, 2))                           # e^{c_L-c_j}
    uf = u.to(acc)
    tri = torch.ones(ln, ln, dtype=torch.bool, device=r.device).tril(-1)
    after_t = tri.view(ln, ln, 1, 1)                          # [t, i]: t > i
    st = (torch.zeros((b, h, kd, vd), dtype=acc, device=r.device)
          if state is None else state.to(acc))
    states = []                             # the chunk states (the kernel
    for c in range(nc):                     # reads the forward's)
        states.append(st)
        st = (ecl[:, c][..., None] * st
              + torch.einsum("bjhk,bjhv->bhkv", kf[:, c] * edec[:, c],
                             vf[:, c]))
    g = (torch.zeros((b, h, kd, vd), dtype=acc, device=r.device)
         if dstate_out is None else dstate_out.to(acc))
    dr, dk, dv, dla = (torch.empty_like(t) for t in (rf, kf, vf, la))
    du = torch.zeros((h, kd), dtype=acc, device=r.device)
    for c in reversed(range(nc)):
        rc, kc, vc, doc = rf[:, c], kf[:, c], vf[:, c], dof[:, c]
        sc, ecp = states[c], torch.exp(cprev[:, c])
        # e^{c_{t-1} - c_j} for j < t: the segment sum over (j, t - 1]
        seg = segment_sums(la[:, c:c + 1])[:, 0]              # [B,t,j,H,K]
        dec = torch.cat([torch.zeros_like(seg[:, :1]), seg[:, :-1].exp()], 1)
        dov = torch.einsum("bthv,bjhv->btjh", doc, vc)
        bonus = torch.diagonal(dov, dim1=1, dim2=2).permute(0, 2, 1)  # [B,L,H]
        sdo = torch.einsum("bhkv,bthv->bthk", sc, doc)        # S do_t
        gv = torch.einsum("bhkv,bjhv->bjhk", g, vc)           # G v_j
        y = dov[..., None] * rc[:, :, None] * kc[:, None] * dec
        dr[:, c] = (ecp * sdo
                    + torch.einsum("btjh,bjhk,btjhk->bthk", dov, kc, dec)
                    + bonus[..., None] * uf * kc)
        dk[:, c] = (torch.einsum("btjh,bthk,btjhk->bjhk", dov, rc, dec)
                    + bonus[..., None] * uf * rc + edec[:, c] * gv)
        a_mat = torch.einsum("bthk,bjhk,btjhk->btjh", rc, kc, dec)
        beta = torch.einsum("bthk,hk,bthk->bth", rc, uf, kc)
        dv[:, c] = (torch.einsum("btjh,bthv->bjhv", a_mat, doc)
                    + beta[..., None] * doc
                    + torch.einsum("bhkv,bjhk->bjhv", g, kc * edec[:, c]))
        du += torch.einsum("bth,bthk->hk", bonus, rc * kc)
        x = rc * ecp * sdo
        z = kc * edec[:, c] * gv
        q = ecl[:, c] * (sc * g).sum(-1)                      # [B,H,K]
        # sum_{t>i} sum_{j<i} y_tj: each row's exclusive prefix over j at
        # i, summed over the rows t > i
        mid = (_before(y, 2) * after_t).sum(1)
        dla[:, c] = _after(x, 1) + mid + q[:, None] + _before(z, 1)
        g = (ecl[:, c][..., None] * g
             + torch.einsum("bthk,bthv->bhkv", rc * ecp, doc))
    wfl = wf.reshape(b, nc * ln, h, kd)[:, :s]

    def unchunk(t):
        return t.reshape(b, nc * ln, h, t.shape[-1])[:, :s]

    dla = unchunk(dla)
    dw = torch.where(wfl >= 1e-30, dla / wfl, torch.zeros_like(dla))
    return (unchunk(dr).to(r.dtype), unchunk(dk).to(k.dtype),
            unchunk(dv).to(v.dtype), dw.to(w.dtype), du.to(u.dtype),
            None if state is None else g.to(state.dtype))


# ==========================================================================
# GP kernel matrix (RBF / Matern-5/2)
# ==========================================================================

def gp_kernel_matrix(x1: torch.Tensor, x2: torch.Tensor,
                     lengthscale: torch.Tensor, variance: torch.Tensor,
                     kind: str = "rbf") -> torch.Tensor:
    """x1: [..., N, D]; x2: [..., M, D]; ARD lengthscale: [D]
    -> [..., N, M] (f32).  Leading dimensions batch (one per expert)."""
    ls = lengthscale.to(torch.float32)
    x1s = x1.to(torch.float32) / ls
    x2s = x2.to(torch.float32) / ls
    d2 = ((x1s ** 2).sum(-1)[..., :, None] + (x2s ** 2).sum(-1)[..., None, :]
          - 2.0 * x1s @ x2s.transpose(-1, -2))
    d2 = torch.clamp(d2, min=0.0)
    if kind == "rbf":
        k = torch.exp(-0.5 * d2)
    elif kind == "matern52":
        r = torch.sqrt(d2 + 1e-12)
        k = (1.0 + math.sqrt(5.0) * r + 5.0 / 3.0 * d2) \
            * torch.exp(-math.sqrt(5.0) * r)
    else:
        raise ValueError(kind)
    return variance.to(torch.float32) * k


def gp_kernel_matrix_grad(grad: torch.Tensor, x1: torch.Tensor,
                          x2: torch.Tensor, lengthscale: torch.Tensor,
                          variance: torch.Tensor, kind: str = "rbf"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `gp_kernel_matrix` (x1 [N, D], x2 [M, D]) in the
    lengthscale and the variance against K's upstream gradient `grad`
    [N, M], in closed form -> (g_ls [D], g_var []):

        g_var = sum G k(d2)
        g_ls_c = var / ls_c * sum G h(d2) (x1s_c - x2s_c)^2

    with h = -2 dk/dd2 (rbf: k; matern52: 5/3 (1 + sqrt5 r) e^(-sqrt5 r),
    r = sqrt(d2 + 1e-12)), zero where the unclamped d2 is negative, as
    `torch.clamp`'s backward.  d2 is the forward's expanded formula.  It
    computes in f32, or in f64 where `grad` is f64.  The plain version of
    the CUDA kernel `gp_kernel.gp_kernel_matrix_grad`; the port's CPU path
    differentiates `gp_kernel_matrix` with autograd instead."""
    dt = torch.promote_types(grad.dtype, torch.float32)
    ls = lengthscale.to(dt)
    x1s = x1.to(dt) / ls
    x2s = x2.to(dt) / ls
    raw = ((x1s ** 2).sum(-1)[:, None] + (x2s ** 2).sum(-1)[None, :]
           - 2.0 * x1s @ x2s.T)
    d2 = torch.clamp(raw, min=0.0)
    if kind == "rbf":
        k = torch.exp(-0.5 * d2)
        h = k
    elif kind == "matern52":
        r = torch.sqrt(d2 + 1e-12)
        e = torch.exp(-math.sqrt(5.0) * r)
        k = (1.0 + math.sqrt(5.0) * r + 5.0 / 3.0 * d2) * e
        h = 5.0 / 3.0 * (1.0 + math.sqrt(5.0) * r) * e
    else:
        raise ValueError(kind)
    g = grad.to(dt)
    w = torch.where(raw >= 0.0, g * h, torch.zeros_like(h))
    diff2 = (x1s[:, None, :] - x2s[None, :, :]) ** 2
    s = torch.einsum("nm,nmd->d", w, diff2)
    return variance.to(dt) * s / ls, (g * k).sum()


def gp_predict(x_train: torch.Tensor, x_star: torch.Tensor,
               lengthscale: torch.Tensor, variance: torch.Tensor,
               alpha: torch.Tensor, linv: torch.Tensor, kind: str = "rbf"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched GP posterior predict.

    Returns (normalised mean [S, M], quadratic form [S]) where
    mean = Ks^T alpha and qf[s] = ||L^-1 ks||^2; the caller maps both
    back to the original output scale.
    """
    ks = gp_kernel_matrix(x_train, x_star, lengthscale, variance, kind)
    mean = ks.transpose(-1, -2) @ alpha
    v = linv @ ks
    qf = (v * v).sum(-2)
    return mean, qf


def gp_predict_experts(x_train: torch.Tensor, x_star: torch.Tensor,
                       lengthscale: torch.Tensor, variance: torch.Tensor,
                       alpha: torch.Tensor, linv: torch.Tensor,
                       kind: str = "rbf"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked local-GP ensemble predict: `gp_predict` batched over the
    expert axis.

    x_train: [E, N, D]; x_star: [E, S, D]; alpha: [E, N, M];
    linv: [E, N, N]; shared hyperparameters
    -> (normalised mean [E, S, M], quadratic form [E, S]).  Zero-padded
    training rows contribute nothing (alpha/linv zero there).
    """
    return gp_predict(x_train, x_star, lengthscale, variance, alpha, linv,
                      kind)
