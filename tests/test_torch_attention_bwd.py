"""The plain attention backward of the port (`repro_torch.kernels.ref.
attention_bwd`, the plain version of the CUDA backward kernel) against the
reference, on the CPU.

The reference's gradient on the path the port replaces is its blocked
custom VJP, `_flash_bwd` (`repro/kernels/ref.py:142`), reached through
`jax.vjp` of `repro.kernels.ref.attention_chunked`.  The port's version
is held to it, and to torch autograd of the port's `ref.attention`, with
the same inputs and output gradient made with numpy: GQA, Dh != Dv,
Sq < Skv under the causal mask (diagonal offset Skv - Sq), and sequence
lengths that leave a ragged last block.  Tolerance 2e-5 in f32: the same
f32 products summed in other orders (XLA's and PyTorch's CPU einsums,
blocked or not).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ops
from torch_port_util import np32

TOL = 2e-5

# (B, Sq, Skv, H, Hkv, Dh, Dv, causal, q_block, kv_block)
CASES = [
    (2, 64, 64, 4, 4, 16, 16, True, 16, 16),     # MHA, blocks divide
    (2, 50, 50, 6, 2, 16, 16, True, 16, 16),     # GQA, ragged last block
    (1, 40, 40, 4, 1, 24, 8, True, 16, 8),       # Dh != Dv, one kv head
    (2, 24, 56, 4, 2, 16, 16, True, 16, 16),     # Sq < Skv, causal offset
    (1, 33, 71, 2, 2, 8, 12, True, 8, 16),       # Sq < Skv, ragged, Dh != Dv
    (2, 48, 48, 4, 2, 16, 16, False, 16, 32),    # full attention
    (1, 24, 40, 3, 3, 8, 8, False, 16, 16),      # full, Sq < Skv
]


def _inputs(b, sq, skv, h, hkv, dh, dv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dv)).astype(np.float32)
    dout = rng.standard_normal((b, sq, h, dv)).astype(np.float32)
    return q, k, v, dout


def _reference_vjp(q, k, v, dout, causal, q_block, kv_block):
    f = lambda q_, k_, v_: jref.attention_chunked(
        q_, k_, v_, causal=causal, q_block=q_block, kv_block=kv_block)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _assert_close(got, want, what):
    got = np32(got)
    err = float(np.max(np.abs(got - want)))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= TOL, f"{what}: {err} > {TOL}"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_bwd_matches_reference_custom_vjp(case):
    b, sq, skv, h, hkv, dh, dv, causal, qb, kb = case
    q, k, v, dout = _inputs(b, sq, skv, h, hkv, dh, dv)
    want_out, want = _reference_vjp(q, k, v, dout, causal, qb, kb)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = tref.attention_lse(tq, tk, tv, causal=causal)
    _assert_close(out, want_out, "out")
    got = tref.attention_bwd(tq, tk, tv, out, lse, tdo, causal=causal,
                             q_block=qb, kv_block=kb)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(g, w, name)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_bwd_matches_autograd_of_plain(case):
    b, sq, skv, h, hkv, dh, dv, causal, qb, kb = case
    q, k, v, dout = _inputs(b, sq, skv, h, hkv, dh, dv, seed=1)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tref.attention(tq, tk, tv, causal=causal)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    o2, lse = tref.attention_lse(*(t.detach() for t in (tq, tk, tv)),
                                 causal=causal)
    got = tref.attention_bwd(tq.detach(), tk.detach(), tv.detach(), o2, lse,
                             torch.from_numpy(dout), causal=causal,
                             q_block=qb, kv_block=kb)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(g, np32(w), name)


def test_lse_matches_reference_forward():
    """The row log-sum-exp the backward takes, against the one the
    reference's blocked forward saves for its VJP."""
    q, k, v, _ = _inputs(2, 50, 70, 4, 2, 16, 8, seed=2)
    k2, v2 = jref._expand_kv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, want = jref._flash_fwd_impl(jnp.asarray(q), k2, v2, True, 16, 16)
    _, got = tref.attention_lse(*map(torch.from_numpy, (q, k, v)))
    _assert_close(got, np.asarray(want), "lse")


def test_attention_bwd_keeps_operand_types():
    q, k, v, dout = (torch.from_numpy(x).to(torch.bfloat16)
                     for x in _inputs(1, 20, 20, 2, 1, 8, 8))
    out, lse = tref.attention_lse(q, k, v)
    assert lse.dtype == torch.float32 and out.dtype == torch.bfloat16
    got = tref.attention_bwd(q, k, v, out, lse, dout)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]


def test_dispatcher_differentiates_on_the_cpu():
    """On the CPU `ops.flash_attention` is the plain version under plain
    autograd: its gradient is the reference's custom VJP's."""
    q, k, v, dout = _inputs(2, 30, 30, 4, 2, 16, 16, seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    _, want = _reference_vjp(q, k, v, dout, True, 16, 16)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(g, w, name)
