"""Serving through the port (`repro_torch.launch.serve`), on the CPU.

The port's `LMServer` with the reference's weights emits the same greedy
tokens as the reference's `LMServer` (an exact match: argmax over f32
logits that agree to ~1e-5, test_torch_models.py); its cached generation
equals repeated full forwards; `serve_benchmark` runs end to end through
the Executor for every arch; a fresh interpreter serving through the port
loads neither `jax` nor `repro`; and without a card the default device
raises.
"""
import gc
import os
import subprocess
import sys
import textwrap
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import device
from repro_torch.core import EvalRequest, Executor, LambdaModel
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.weights import params_from_numpy
from torch_port_util import on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")

ARCHS = ["zamba2-2.7b", "starcoder2-3b", "rwkv6-3b", "qwen3-14b",
         "yi-34b", "minicpm3-4b", "dbrx-132b", "deepseek-v3-671b"]
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_server(arch):
    """Same weights, same prompt: the same tokens.  The prompt length (11)
    is bucketed to 16 for starcoder2 and exact for the recurrent archs."""
    jsrv = jserve.LMServer(jconfigs.get_reduced(arch), max_len=48, seed=2)
    tsrv = tserve.LMServer(tconfigs.get_reduced(arch), max_len=48, seed=2)
    tsrv.params = params_from_numpy(tsrv.cfg,
                                    jax.tree.map(np.asarray, jsrv.params))
    prompt = np.random.default_rng(1).integers(
        0, tsrv.cfg.vocab_size, (1, 11)).astype(np.int32)
    want = jsrv.generate(prompt, 6)
    got = tsrv.generate(prompt, 6)
    assert got.shape == (1, 6)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_generation_matches_teacher_forced(arch):
    """Bucketed prefill + cached decode emit the greedy tokens of repeated
    full forwards (the port's twin of tests/test_serve.py).  An MoE arch
    runs at the capacity factor E / k, where no assignment can drop (each
    expert's capacity is the token count): the bucketed prefill routes
    the pad tokens too and sizes its capacity by the bucket, so with drops
    it may drop other assignments than a forward over the prompt alone,
    as the reference's does (`test_moe_served_tokens_follow_the_reference`)."""
    cfg = tconfigs.get_reduced(arch)
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.moe_top_k)
    srv = tserve.LMServer(cfg, max_len=64, seed=3)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 6))
    dropped = []
    with tmoe.observe(lambda idx, keep, cap: dropped.append(
            int((~keep).sum()))):
        out = srv.generate(prompt, 4)
        toks, ref = prompt.copy(), []
        for _ in range(4):
            logits, _, _ = tmodel.forward(
                srv.params, {"tokens": torch.from_numpy(toks)}, cfg)
            ref.append(int(logits[0, -1, :cfg.vocab_size].argmax()))
            toks = np.concatenate([toks, [[ref[-1]]]], 1)
    assert out[0].tolist() == ref
    assert sum(dropped) == 0
    assert len(dropped) == (cfg.n_layers - cfg.first_k_dense) * 8 * bool(
        cfg.n_experts)


def test_moe_served_tokens_follow_the_reference():
    """At dbrx's own capacity factor (1.25) a bucketed prefill sizes each
    expert's capacity by the bucket (16 tokens, pads included), a forward
    over the prompt by its 6 tokens, so the two may drop other
    assignments; the port keeps the reference's behaviour: the same served
    tokens, and the same teacher-forced ones."""
    arch = "dbrx-132b"
    jsrv = jserve.LMServer(jconfigs.get_reduced(arch), max_len=64, seed=3)
    tsrv = tserve.LMServer(tconfigs.get_reduced(arch), max_len=64, seed=3)
    tsrv.params = params_from_numpy(tsrv.cfg,
                                    jax.tree.map(np.asarray, jsrv.params))
    prompt = np.random.default_rng(0).integers(
        0, tsrv.cfg.vocab_size, (1, 6)).astype(np.int32)
    caps = []
    with tmoe.observe(lambda idx, keep, cap: caps.append(cap)):
        served = tsrv.generate(prompt, 4)[0].tolist()
        tmodel.forward(tsrv.params, {"tokens": torch.from_numpy(prompt)},
                       tsrv.cfg)
    # per MoE layer: the prefill's capacity, then 3 decode steps', then
    # the forward's: ceil(1.25 * T * k / E) at T = 16, 1, 6
    assert caps == [10] * 2 + [1] * 6 + [4] * 2
    assert served == np.asarray(jsrv.generate(prompt, 4))[0].tolist()
    toks = prompt.copy()
    for _ in range(4):
        want, _, _ = jmodel.forward(jsrv.params, {"tokens": toks}, jsrv.cfg)
        got, _, _ = tmodel.forward(
            tsrv.params, {"tokens": torch.from_numpy(toks)}, tsrv.cfg)
        nxt = int(np.argmax(np.asarray(want)[0, -1, :tsrv.cfg.vocab_size]))
        assert int(got[0, -1, :tsrv.cfg.vocab_size].argmax()) == nxt
        toks = np.concatenate([toks, [[nxt]]], 1).astype(np.int32)


def test_bucket_sizes_are_powers_of_two():
    srv = tserve.LMServer.__new__(tserve.LMServer)
    srv.cfg = tconfigs.get_reduced("starcoder2-3b")
    srv.min_bucket, srv.max_len = 16, 256
    assert [srv._bucket(s) for s in (5, 16, 17, 300)] == [16, 16, 32, 256]
    for arch in ("zamba2-2.7b", "rwkv6-3b"):          # recurrent: exact
        srv.cfg = tconfigs.get_reduced(arch)
        assert [srv._bucket(s) for s in (5, 16, 17, 255)] == [5, 16, 17, 255]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_benchmark_end_to_end(arch):
    for persistent in (True, False):
        out = tserve.serve_benchmark(arch, n_requests=3, max_new=2,
                                     n_workers=1, persistent=persistent,
                                     max_len=32)
        assert out["tokens"] == 3 * 2
        assert out["summary"].n_tasks == 3
        assert len(out["records"]) == 3


@pytest.mark.parametrize("fail_first", [False, True])
@pytest.mark.parametrize("persistent", [True, False])
def test_executor_releases_servers_without_a_collector(persistent,
                                                       fail_first):
    """A full-width server holds tens of GiB on the card: a fresh server
    is gone before the next request builds its own, also when its request
    raised inside the model, and a persistent one once the executor shuts
    down, by reference counts alone (the collector off).  The reference
    keeps both longer (ROADMAP.md, divergences)."""

    class Weights:
        pass

    alive, live_at_build, calls = weakref.WeakSet(), [], []

    def factory():
        live_at_build.append(len(alive))
        w = Weights()
        alive.add(w)

        def fn(params, config):
            calls.append(id(w))
            if fail_first and len(calls) == 1:
                raise RuntimeError("the model failed")
            return [[id(w)]]

        return LambdaModel("m", fn, input_size=-1, output_size=-1)

    gc.collect()
    gc.disable()
    try:
        with Executor({"m": factory}, n_workers=1,
                      persistent_servers=persistent) as ex:
            results = ex.run_all([EvalRequest("m", [float(i)])
                                  for i in range(3)], timeout=60.0)
        assert all(r.status == "ok" for r in results)
        assert len(calls) == 3 + fail_first
        builds = 1 if persistent else 3 + fail_first
        assert live_at_build == [0] * builds
        assert len(alive) == 0
    finally:
        gc.enable()


def test_serving_loads_neither_jax_nor_repro(tmp_path):
    """Reduced zamba2, rwkv6, minicpm3 (MLA) and deepseek-v3 (MLA, MoE)
    serve_benchmarks through the port, in a fresh interpreter: no `jax` or
    `repro` module is loaded."""
    script = textwrap.dedent("""
        import sys
        from repro_torch import device
        device.set_device("cpu")
        from repro_torch.launch import serve
        for arch in ("zamba2-2.7b", "rwkv6-3b", "minicpm3-4b",
                     "deepseek-v3-671b"):
            out = serve.serve_benchmark(arch, n_requests=2, max_new=2,
                                        n_workers=1, max_len=32)
            assert out["tokens"] == 4, arch
        loaded = sorted(m for m in sys.modules
                        if m in ("jax", "repro") or m.startswith("jax.")
                        or m.startswith("repro."))
        print("LOADED", loaded)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_lm_server_without_card_raises(monkeypatch):
    """With the default device (CUDA) and no card, the server raises
    rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    device.set_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="set_device"):
            tserve.LMServer(tconfigs.get_reduced("zamba2-2.7b"))
    finally:
        device.set_device("cpu")
