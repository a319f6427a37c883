"""The port's optimizer and data pipeline against the reference, on the
CPU: `repro_torch.optim` (AdamW, the cosine schedule, bf16 moments, int8
compression with error feedback) and `repro_torch.data` (the synthetic
stream, the memmap corpus, host sharding), with the reference's own
checks (tests/test_substrate.py) held on both packages.

Tolerances: the data and the int8 payload are equal bit for bit (the
same numpy generator; `torch.round` and `jnp.round` both round half to
even).  The schedule and AdamW are f32 in both, within 1e-6 relative
(XLA and PyTorch may fuse or order an f32 expression differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jdata
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.data import pipeline as tdata
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from torch_port_util import np32


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------
SCHEDULES = [dict(), dict(peak_lr=1.0, min_lr=0.1, warmup_steps=10,
                          total_steps=100),
             dict(peak_lr=2e-3, min_lr=0.0, warmup_steps=0, total_steps=250)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_cosine_schedule_every_step(kw):
    jc, tc = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    steps = np.arange(301, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jadamw.cosine_schedule(s, jc))(
        jnp.asarray(steps)))
    got = tadamw.cosine_schedule(torch.from_numpy(steps), tc)
    # 1e-6 of the peak absolute: near the end 1 + cos(pi prog) cancels, and
    # one f32 step of either cosine is a large share of a small lr
    _close(got, want, atol=1e-6 * tc.peak_lr)


def test_cosine_schedule_shape():
    """tests/test_substrate.py::test_cosine_schedule_shape on the port."""
    cfg = tadamw.AdamWConfig(peak_lr=1.0, min_lr=0.1, warmup_steps=10,
                             total_steps=100)
    lrs = [float(tadamw.cosine_schedule(torch.tensor(s), cfg))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0 + 1e-6
    assert abs(lrs[10] - 1.0) < 0.01
    assert lrs[-1] == pytest.approx(0.1, abs=0.01)


def test_adamw_reduces_quadratic_like_reference():
    """tests/test_substrate.py::test_adamw_reduces_quadratic on both
    packages, step by step."""
    kw = dict(peak_lr=0.1, warmup_steps=5, total_steps=100, weight_decay=0.0)
    jc, tc = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    jp = {"w": jnp.array([3.0, -2.0])}
    tp = {"w": torch.tensor([3.0, -2.0])}
    jo, to = jadamw.init_opt_state(jp, jc), tadamw.init_opt_state(tp, tc)
    loss = lambda p: jnp.sum(p["w"] ** 2)
    for _ in range(60):
        jg = jax.grad(loss)(jp)
        jp, jo, jm = jadamw.adamw_update(jp, jg, jo, jc)
        tp, to, tm = tadamw.adamw_update(tp, {"w": 2 * tp["w"]}, to, tc)
        _close(tp["w"], jp["w"], rtol=1e-5, atol=1e-7)
        _close(tm["lr"], jm["lr"])
        _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-5)
    assert int(to["step"]) == int(jo["step"]) == 60
    assert float((tp["w"] ** 2).sum()) < 0.05


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments, param_dtype):
    """Three steps on a tree of mixed shapes, with decay, a clipped
    gradient and moments in `moments`: parameters, moments, lr and the
    gradient norm against the reference."""
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5,
              moments_dtype=moments)
    jc, tc = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 3), "b": (5,), "c": (2, 4, 3)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    jdt = jnp.dtype(param_dtype)
    tdt = getattr(torch, param_dtype)
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    jo, to = jadamw.init_opt_state(jp, jc), tadamw.init_opt_state(tp, tc)
    assert all(m.dtype == getattr(torch, moments)
               for m in to["m"].values())
    bf16 = "bfloat16" in (moments, param_dtype)
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jp, jo, jm = jadamw.adamw_update(
            jp, {k: jnp.asarray(v, jdt) for k, v in g.items()}, jo, jc)
        tp, to, tm = tadamw.adamw_update(
            tp, {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, to,
            tc)
        _close(tm["lr"], jm["lr"])
        _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-5)
        # bf16: one rounding step of either side may differ where the f32
        # results sit near a bf16 tie
        tol = dict(rtol=1e-2, atol=1e-2) if bf16 else dict(rtol=1e-5,
                                                          atol=1e-7)
        for k in shapes:
            _close(tp[k].float(), np.asarray(jp[k], np.float32), **tol)
            _close(to["m"][k].float(), np.asarray(jo["m"][k], np.float32),
                   **tol)
            _close(to["v"][k].float(), np.asarray(jo["v"][k], np.float32),
                   **tol)
    assert int(to["step"]) == 3


def _adamw_whole(params, grads, state, cfg):
    """The update as whole-tensor expressions, out of place: the
    arithmetic `adamw_update` forms slice by slice, in place."""
    step = state["step"] + 1
    lr = tadamw.cosine_schedule(step, cfg)
    gnorm = tadamw.global_norm(grads)
    scale = torch.minimum(torch.ones(()), cfg.clip_norm / torch.maximum(
        gnorm, torch.full((), 1e-12)))
    mdt = getattr(torch, cfg.moments_dtype)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2), stepf)
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        g32 = grads[k].float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g32)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m32.to(mdt))
        v.copy_(v32.to(mdt))
    return params, dict(state, step=step), {"lr": lr, "grad_norm": gnorm}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_sliced_adamw_update_is_bitwise_the_whole(monkeypatch, moments,
                                                  param_dtype):
    """`adamw_update` walks a tensor larger than `_SLICE` elements one
    leading-dimension slice at a time, in place.  With the constant
    patched to 12, tensors of 2 to 3 slices (and one whose rows are each
    larger than a slice) take three steps: parameters, moments and
    metrics equal the unsliced update's bit for bit, and the whole-tensor
    out-of-place expressions' (`_adamw_whole`; elementwise arithmetic in
    the same order)."""
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5,
              moments_dtype=moments)
    cfg = tadamw.AdamWConfig(**kw)
    dt = getattr(torch, param_dtype)
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 3), "b": (30,), "c": (2, 4, 3), "d": (3, 20),
              "e": (5,), "f": ()}
    p0 = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(dt) for k, s in shapes.items()}
    grads = [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .to(dt) for k, s in shapes.items()} for _ in range(3)]
    out = {}
    for size in (12, 1 << 26, None):
        monkeypatch.setattr(tadamw, "_SLICE", size or 1 << 26)
        if size == 12:
            assert [len(tadamw._slices(v)) for v in p0.values()] \
                == [2, 3, 2, 3, 1, 1]
        update = tadamw.adamw_update if size else _adamw_whole
        params = {k: v.clone() for k, v in p0.items()}
        opt = tadamw.init_opt_state(params, cfg)
        for g in grads:
            params, opt, met = update(params, g, opt, cfg)
        out[size] = (params, opt, met)
    pa, oa, ma = out[12]
    for pb, ob, mb in (out[1 << 26], out[None]):
        for k in shapes:
            assert torch.equal(pa[k], pb[k]) and pa[k].dtype == dt, k
            assert torch.equal(oa["m"][k], ob["m"][k]), k
            assert torch.equal(oa["v"][k], ob["v"][k]), k
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
        assert int(oa["step"]) == int(ob["step"]) == 3


def test_adamw_slices_an_expert_stack_one_expert_at_a_time():
    """At the constant's 2^26 elements, dbrx-132b's [16, 6144, 10752]
    expert stack is 16 slices of one expert (66,060,288 elements each),
    and its embedding [100352, 6144] slices of 10,922 rows."""
    stack = torch.empty(16, 6144, 10752, device="meta")
    table = torch.empty(100352, 6144, device="meta")
    assert tadamw._SLICE == 1 << 26
    assert tadamw._slices(stack) == [slice(i, i + 1) for i in range(16)]
    rows = {s.stop - s.start for s in tadamw._slices(table)}
    assert rows == {10922} and len(tadamw._slices(table)) == 10


def test_adamw_takes_host_tensors_in_finer_slices():
    """On the CPU the update's slices hold at most `_HOST_SLICE` = 2^20
    elements (its temporaries stay under the size the C allocator maps
    afresh), elsewhere `_SLICE`: a [16, 512, 256] tensor (2^21 elements)
    is two slices of 8 rows on the host and one whole on another device.
    The bits do not depend on the slicing
    (`test_sliced_adamw_update_is_bitwise_the_whole`)."""
    assert tadamw._HOST_SLICE == 1 << 20
    assert tadamw._slices(torch.empty(16, 512, 256)) == [slice(0, 8),
                                                         slice(8, 16)]
    assert tadamw._slices(torch.empty(16, 512, 256, device="meta")) == [...]


def test_bf16_moments_dtype():
    """tests/test_substrate.py::test_bf16_moments_dtype on the port."""
    cfg = tadamw.AdamWConfig(moments_dtype="bfloat16")
    params = {"w": torch.ones(4)}
    opt = tadamw.init_opt_state(params, cfg)
    assert opt["m"]["w"].dtype == torch.bfloat16
    _, opt2, _ = tadamw.adamw_update(params, {"w": torch.ones(4)}, opt, cfg)
    assert opt2["v"]["w"].dtype == torch.bfloat16


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in {"a": (100, 7), "b": (3,), "c": (4, 4, 4)}.items()}
    want = jadamw.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    got = tadamw.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    _close(got, want)


def test_global_norm_of_large_gradients_is_finite():
    """A fault of the reference, pinned: its global norm squares in f32 and
    overflows to inf past |x| ~ 1.8e19, so the clip scale is 0 and AdamW
    takes no gradient step.  The port's norm stays finite and right."""
    x = np.array([3e21, -4e21, 1.0], np.float32)
    assert np.isinf(float(jadamw.global_norm({"w": jnp.asarray(x)})))
    got = tadamw.global_norm({"w": torch.from_numpy(x),
                              "z": torch.zeros(3)})
    assert float(got) == pytest.approx(5e21, rel=1e-6)
    cfg = tadamw.AdamWConfig(peak_lr=1.0, warmup_steps=0, weight_decay=0.0)
    p = {"w": torch.zeros(3)}
    _, _, m = tadamw.adamw_update(p, {"w": torch.from_numpy(x)},
                                  tadamw.init_opt_state(p, cfg), cfg)
    assert np.isfinite(float(m["grad_norm"]))
    assert float(p["w"].abs().max()) > 0      # a clipped step was taken


def test_global_norm_edge_cases():
    assert float(tadamw.global_norm({"a": torch.zeros(4)})) == 0.0
    assert np.isinf(float(tadamw.global_norm(
        {"a": torch.tensor([1.0, float("inf")])})))
    assert np.isnan(float(tadamw.global_norm(
        {"a": torch.tensor([1.0, float("nan")])})))


# --------------------------------------------------------------------------
# gradient compression
# --------------------------------------------------------------------------
def _tie_block():
    """One block whose scale is 1 (max |x| = 127) and whose other values
    sit exactly on halves, where rounding half to even decides."""
    x = np.full(256, 0.25, np.float32)
    x[0] = 127.0
    x[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5]
    return x


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4097])
def test_int8_payload_equals_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.uniform(0.1, 10)).astype(np.float32)
    jq, js = jcomp._quantize(jnp.asarray(x))
    tq, ts = tcomp._quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_payload_rounds_half_to_even_as_reference():
    x = _tie_block()
    jq, _ = jcomp._quantize(jnp.asarray(x))
    tq, ts = tcomp._quantize(torch.from_numpy(x))
    assert float(ts[0, 0]) == 1.0
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -4]


def test_compression_error_feedback_invariant():
    """tests/test_substrate.py::test_compression_error_feedback_invariant
    on the port, and the decompressed gradient and error against the
    reference's."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal(1000).astype(np.float32)
    jdeq, jerr = jcomp.compress_with_feedback(
        {"w": jnp.asarray(g)}, jcomp.init_compression_state({"w": jnp.asarray(g)}))
    tg = {"w": torch.from_numpy(g)}
    deq, err = tcomp.compress_with_feedback(tg,
                                            tcomp.init_compression_state(tg))
    np.testing.assert_allclose(deq["w"].numpy() + err["w"].numpy(), g,
                               atol=1e-6)
    scale = np.abs(g).reshape(-1, 250).max()  # loose bound, as the reference
    assert np.abs(err["w"].numpy()).max() <= scale / 127 + 1e-6
    np.testing.assert_array_equal(deq["w"].numpy(), np.asarray(jdeq["w"]))
    np.testing.assert_array_equal(err["w"].numpy(), np.asarray(jerr["w"]))


@pytest.mark.parametrize("seed,n", [(0, 10), (1, 300), (2, 600), (3, 257)])
def test_compression_roundtrip_accumulates_like_reference(seed, n):
    """tests/test_substrate.py::test_compression_roundtrip_accumulates_
    correctly on the port, at fixed draws: the mean of 20 decompressed
    gradients converges to the true one, and each step's payload is the
    reference's."""
    rng = np.random.default_rng(seed)
    true = rng.standard_normal(n).astype(np.float32)
    tg, jg = {"w": torch.from_numpy(true)}, {"w": jnp.asarray(true)}
    terr, jerr = tcomp.init_compression_state(tg), jcomp.init_compression_state(jg)
    total = np.zeros(n)
    for _ in range(20):
        deq, terr = tcomp.compress_with_feedback(tg, terr)
        jdeq, jerr = jcomp.compress_with_feedback(jg, jerr)
        np.testing.assert_array_equal(deq["w"].numpy(), np.asarray(jdeq["w"]))
        total += deq["w"].numpy()
    np.testing.assert_allclose(total / 20, true,
                               atol=np.abs(true).max() / 127 + 1e-5)


# --------------------------------------------------------------------------
# data pipeline
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("vocab,seq,batch", [(97, 32, 4), (49152, 64, 2),
                                             (128, 16, 8)])
def test_synthetic_batches_equal_reference(seed, vocab, seq, batch):
    jp = jdata.SyntheticLM(vocab, seq, batch, seed)
    tp = tdata.SyntheticLM(vocab, seq, batch, seed)
    for step in (0, 1, 5, 39):
        a, b = jp.batch(step), tp.batch(step)
        assert a.keys() == b.keys()
        assert b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_synthetic_deterministic_and_structured():
    """tests/test_substrate.py::test_synthetic_deterministic_and_structured
    on the port."""
    pipe = tdata.SyntheticLM(vocab_size=97, seq_len=32, global_batch=4,
                             seed=1)
    a, b = pipe.batch(5), pipe.batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(pipe.batch(6)["tokens"], a["tokens"])
    t = a["tokens"].astype(np.int64)
    follows = (t[:, 1:] == (t[:, :-1] * (6364136223846793005 % 97) + 7) % 97)
    assert follows.mean() > 0.8


def test_synthetic_embeddings_mode_equals_reference():
    jp = jdata.SyntheticLM(97, 8, 2, 0, embeddings_dim=16)
    tp = tdata.SyntheticLM(97, 8, 2, 0, embeddings_dim=16)
    a, b = jp.batch(3), tp.batch(3)
    assert b["embeddings"].shape == (2, 8, 16) and b["labels"].shape == (2, 8)
    for k in ("embeddings", "labels"):
        np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_iterates_by_step():
    it = iter(tdata.SyntheticLM(50, 8, 2, 3))
    for step in range(3):
        np.testing.assert_array_equal(
            next(it)["tokens"], jdata.SyntheticLM(50, 8, 2, 3).batch(step)["tokens"])


def test_host_shard_partition():
    """tests/test_substrate.py::test_host_shard_partition on the port, and
    the single-process default."""
    slices = [tdata.host_shard(64, i, 4) for i in range(4)]
    assert [s[1] for s in slices] == [16] * 4
    assert sorted(o for o, _ in slices) == [0, 16, 32, 48]
    assert slices == [jdata.host_shard(64, i, 4) for i in range(4)]
    assert tdata.host_shard(8) == (0, 8)
    with pytest.raises(AssertionError):
        tdata.host_shard(10, 0, 4)


@pytest.mark.parametrize("pi", [0, 1])
def test_sharded_synthetic_batches_equal_reference(pi):
    jp, tp = jdata.SyntheticLM(61, 12, 8, 2), tdata.SyntheticLM(61, 12, 8, 2)
    for step in (0, 4):
        np.testing.assert_array_equal(
            jp.batch(step, process_index=pi, process_count=2)["tokens"],
            tp.batch(step, process_index=pi, process_count=2)["tokens"])


@pytest.mark.parametrize("seed", [0, 3])
def test_memmap_batches_equal_reference(tmp_path, seed):
    """tests/test_substrate.py::test_memmap_corpus on the port, with the
    corpus the reference's `build_demo` writes read by both."""
    p = tmp_path / "corpus.bin"
    jdata.MemmapCorpus.build_demo(p, vocab_size=50, n_tokens=4096, seed=seed)
    q = tmp_path / "corpus_port.bin"
    tdata.MemmapCorpus.build_demo(q, vocab_size=50, n_tokens=4096, seed=seed)
    assert p.read_bytes() == q.read_bytes()
    jp = jdata.MemmapCorpus(p, vocab_size=50, seq_len=16, global_batch=2,
                            seed=seed)
    tp = tdata.MemmapCorpus(p, vocab_size=50, seq_len=16, global_batch=2,
                            seed=seed)
    for step in (0, 1, 9):
        b = tp.batch(step)
        assert b["tokens"].shape == (2, 16) and b["tokens"].max() < 50
        np.testing.assert_array_equal(b["tokens"], jp.batch(step)["tokens"])


def test_make_pipeline_kinds(tmp_path):
    syn = tdata.make_pipeline("synthetic", vocab_size=30, seq_len=8,
                              global_batch=2, seed=4)
    assert isinstance(syn, tdata.SyntheticLM)
    p = tmp_path / "c.bin"
    tdata.MemmapCorpus.build_demo(p, 30, 1024)
    mm = tdata.make_pipeline("memmap", vocab_size=30, seq_len=8,
                             global_batch=2, corpus_path=p)
    assert isinstance(mm, tdata.MemmapCorpus)
    with pytest.raises(ValueError):
        tdata.make_pipeline("nope", vocab_size=30, seq_len=8, global_batch=2)
