"""The arithmetic of the CUDA attention backward's bf16 route, emulated in
plain PyTorch on the CPU and held to the oracles the card holds the kernel
to, before any card runs it.

The bf16 route (`flash_attention_bwd` in
`src/repro_torch/kernels/csrc/flash_attention.cu`) multiplies on the
tensor cores: bf16 operands, f32 sums.  It recomputes S = Q K^T and
dP = dO V^T as f32 sums of bf16 products, P = exp(S / sqrt(Dh) - lse)
and dS = P (dP - D) in f32, with D = rowsum(dO O) from the bf16 forward's
output; then it rounds P and dS to bf16 for the three products that take
them (dV = P^T dO, dK = dS^T Q / sqrt(Dh), dQ = dS K / sqrt(Dh)), sums
those in f32 and rounds each gradient to bf16 once.  Rounding P and dS is
what the reference does not do (at most 2^-9 relative each).  The output
O and lse it takes come from the bf16 forward, which rounds P before
P V; `_forward` emulates that too.

Tolerance 2e-2 max|g| per gradient, the card's for bf16: against the
float64 oracle (autograd of `repro_torch.kernels.ref.attention`, and the
plain blocked backward `ref.attention_bwd`, both in f64 on the bf16
inputs, the latter fed the emulated forward's output and lse), and
against the reference's custom VJP (`repro.kernels.ref.attention_chunked`
through `jax.vjp`) on the same numpy inputs in bf16.  Shapes: starcoder2's
GQA group of 12 and MHA, Dh = Dv = 128, MLA's Dh 192 with Dv 128,
zamba2's Dh 80, Sq < Skv, ragged lengths, causal and full, and q scaled by
8 for a peaked softmax.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from torch_port_util import np32

TOL = 2e-2
LOG2E = 1.4426950408889634

# (b, sq, skv, h, hkv, dh, dv)
SHAPES = [(1, 96, 96, 12, 1, 128, 128),     # starcoder2's group of 12
          (2, 70, 70, 3, 3, 80, 80),         # MHA, zamba2's Dh 80, ragged
          (1, 40, 100, 4, 4, 192, 128),      # MLA widths, Sq < Skv
          (1, 33, 77, 6, 2, 128, 128)]       # Sq < Skv, ragged, GQA 3:1


def _inputs(b, sq, skv, h, hkv, dh, dv, q_scale, seed=0):
    rng = np.random.default_rng(seed)
    q = q_scale * rng.standard_normal((b, sq, h, dh))
    k = rng.standard_normal((b, skv, hkv, dh))
    v = rng.standard_normal((b, skv, hkv, dv))
    dout = rng.standard_normal((b, sq, h, dv))
    # bf16 values, carried as f32 numpy arrays to both packages
    return [torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()
            for a in (q, k, v, dout)]


def _scores(q, k, causal):
    """f32 sums of the bf16 products Q K^T, [B,H,Sq,Skv], and the mask of
    visible pairs (diagonal offset Skv - Sq)."""
    h, hkv = q.shape[2], k.shape[2]
    k = k.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    sq, skv = q.shape[1], k.shape[1]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask = mask.tril(diagonal=skv - sq)
    return s, mask


def _forward(q, k, v, causal):
    """The bf16 forward route: (O in bf16, lse f32 [B,H,Sq]), P rounded to
    bf16 before P V."""
    s, mask = _scores(q, k, causal)
    s = (s / math.sqrt(q.shape[-1])).masked_fill(~mask, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    ve = v.repeat_interleave(q.shape[2] // v.shape[2], dim=2).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), ve)
    out = (o / l.transpose(1, 2)[..., None]).bfloat16()
    return out, m[..., 0] + torch.log(l)


def _tensor_core_bwd(q, k, v, out, lse, dout, causal):
    """The bf16 backward route: (dq, dk, dv) in bf16."""
    b, sq, h, dh = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    rep = h // hkv
    ke = k.repeat_interleave(rep, dim=2).float()
    ve = v.repeat_interleave(rep, dim=2).float()
    qf, dof = q.float(), dout.float()
    dd = (dof * out.float()).sum(-1).transpose(1, 2)           # [B,H,Sq]
    s, mask = _scores(q, k, causal)
    p = torch.exp2(s * (LOG2E / math.sqrt(dh)) - (lse * LOG2E)[..., None])
    p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, ve)
    ds = p * (dp - dd[..., None])
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    scale = 1.0 / math.sqrt(dh)
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, ke) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qf) * scale
    dvv = torch.einsum("bhqk,bqhd->bkhd", pb, dof)
    dk = dk.view(b, skv, hkv, rep, dh).sum(3)
    dvv = dvv.view(b, skv, hkv, rep, dv).sum(3)
    return tuple(t.bfloat16() for t in (dq, dk, dvv))


def _emulate(arrays, causal):
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in arrays)
    out, lse = _forward(q, k, v, causal)
    return (q, k, v, out, lse, dout), _tensor_core_bwd(q, k, v, out, lse,
                                                       dout, causal)


def _assert_close(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = np32(g.float()), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        assert np.isfinite(g).all(), (what, name)
        err = float(np.max(np.abs(g.astype(np.float64) - w)))
        scale = float(np.max(np.abs(w)))
        assert err <= TOL * scale, f"{what} {name}: {err} > {TOL} * {scale}"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_backward_emulation_matches_f64_oracle(shape, q_scale, causal):
    ops, got = _emulate(_inputs(*shape, q_scale), causal)
    q, k, v, out, lse, dout = ops
    plain = tref.attention_bwd(*(t.double() for t in ops), causal=causal)
    _assert_close(got, [t.numpy() for t in plain], "plain backward (f64)")
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(tref.attention(q64, k64, v64, causal=causal),
                               (q64, k64, v64), dout.double())
    _assert_close(got, [t.numpy() for t in auto], "autograd (f64)")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_backward_emulation_matches_reference_vjp(shape, q_scale,
                                                       causal):
    arrays = _inputs(*shape, q_scale)
    _, got = _emulate(arrays, causal)
    q, k, v, dout = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    f = lambda q_, k_, v_: jref.attention_chunked(q_, k_, v_, causal=causal,
                                                  q_block=32, kv_block=32)
    out, vjp = jax.vjp(f, q, k, v)
    assert out.dtype == jnp.bfloat16
    want = [np.asarray(g, np.float32) for g in vjp(dout)]
    _assert_close(got, want, "reference custom VJP (bf16)")

