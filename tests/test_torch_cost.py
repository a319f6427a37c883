"""The port's cost analysis and dry run (`repro_torch.launch.cost`,
`launch.dryrun`) against the reference's HLO walker
(`repro.launch.hlo_cost`), and on `meta` tensors against the CPU.

Flops are compared exactly: the reference's walker counts 2 |out| x the
contraction of every `dot` in the compiled step, the port every product
the eager step dispatches, and for the dense, MLA and MoE archs the two
steps run the same products.  Bytes are not compared: XLA fuses
elementwise ops and keeps their interiors out of HBM, eager PyTorch runs
each op on its own, so the two count different traffic by design.

On `meta` the LM kernels' wrappers record their calls with their `cost()`
(the least work, causal pairs only) where the CPU runs their plain
versions (full score matrices), so the two agree on the flops outside the
kernels, not on the total.  zamba2 and rwkv6 factor the chunked SSD and
WKV differently from the reference, so they are held only CPU against
meta.
"""
import dataclasses
import functools
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro import configs as jconfigs
from repro.launch import hlo_cost
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as jmodel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import abstract_opt_state
from repro_torch import configs
from repro_torch.core import backends
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gp_kernel, ops
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import rwkv6_wkv as wkv
from repro_torch.launch import cost, dryrun, specs
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model
from repro_torch.models.config import ShapeConfig
from repro_torch.obs.calib import calibrate, hlo_runtime_prior
from repro_torch.optim import AdamWConfig, init_opt_state

from torch_port_util import on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_cpu")
ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 16
# exact flops of the reduced archs at B 2, S 16: the forward's logits and
# one train step (AdamW), as both packages count them
FLOPS = {"starcoder2-3b": (4_456_448, 13_369_344),
         "qwen3-14b": (5_505_024, 16_515_072),
         "minicpm3-4b": (6_029_312, 18_087_936),
         "dbrx-132b": (10_256_384, 30_769_152),
         "deepseek-v3-671b": (11_173_888, 44_183_424)}
RECURRENT = ("zamba2-2.7b", "rwkv6-3b")
MODES = ("forward", "train")


@functools.lru_cache(maxsize=None)
def _reference_flops(arch: str, mode: str) -> float:
    cfg = jconfigs.get_reduced(arch)
    ap = jmodel.abstract_params(cfg)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if mode == "forward":
        lowered = jax.jit(lambda p, b: jmodel.forward(p, b, cfg)[0]).lower(
            ap, batch)
    else:
        opt_cfg = JAdamWConfig(moments_dtype=cfg.moments_dtype)
        lowered = jax.jit(jmake_train_step(cfg, opt_cfg)).lower(
            ap, abstract_opt_state(ap, opt_cfg), batch)
    return hlo_cost.analyze(lowered.compile().as_text())["flops"]


def _forward(params, batch, cfg):
    with torch.no_grad():
        return model.forward(params, batch, cfg)[0]


def _port_analysis(cfg, mode: str, dev: str, batch: int = B) -> dict:
    """`cost.analyze` of the port's forward or train step of `cfg` on the
    CPU (seeded weights) or on `meta`."""
    params = (model.init_params(cfg, 0, "cpu") if dev == "cpu"
              else model.LM(cfg, "meta"))
    tokens = {"tokens": torch.zeros((batch, S), dtype=torch.long,
                                    device=dev)}
    if mode == "forward":
        return cost.analyze(_forward, params, tokens, cfg)
    params.trainable()
    opt_cfg = AdamWConfig(moments_dtype=cfg.moments_dtype)
    opt = init_opt_state(dict(params.named_parameters()), opt_cfg)
    return cost.analyze(make_train_step(cfg, opt_cfg), params, opt, tokens)


@functools.lru_cache(maxsize=None)
def _reduced_analysis(arch: str, mode: str, dev: str) -> dict:
    return _port_analysis(configs.get_reduced(arch), mode, dev)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", sorted(FLOPS))
def test_flops_equal_the_reference_walker(arch, mode):
    got = _reduced_analysis(arch, mode, "cpu")
    want = _reference_flops(arch, mode)
    assert got["flops"] == want == FLOPS[arch][MODES.index(mode)]
    assert set(got["flops_by_type"]) == {"float32"}
    # one device: the reference's collective fields, empty
    assert got["collective_bytes"] == 0 and got["collectives"] == {}


def _kernel_cost(name: str, operands) -> dict:
    """The cost() of one call of kernel `name` on meta tensors of the
    recorded operand shapes and types."""
    ts = [torch.empty(shape, dtype=getattr(torch, t), device="meta")
          for shape, t in operands]
    if name.startswith("flash_attention"):
        fn = fa.bwd_cost if name.endswith("_bwd") else fa.cost
        return fn(*ts)
    mod = ssd if name.startswith("mamba2") else wkv
    if name.endswith("_bwd"):
        return mod.bwd_cost(*ts, None, None)
    return mod.cost(*ts, None)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", sorted(FLOPS) + list(RECURRENT))
def test_meta_counts_the_cpus_flops_outside_the_kernels(arch, mode):
    cpu = _reduced_analysis(arch, mode, "cpu")
    meta = _reduced_analysis(arch, mode, "meta")
    assert meta["flops_outside_kernels"] == cpu["flops_outside_kernels"]
    assert meta["flops"] == (meta["flops_outside_kernels"]
                             + sum(k["flops"]
                                   for k in meta["kernels"].values()))
    want = ({"mamba2_ssd"} if arch == "zamba2-2.7b" else set()) | (
        {"rwkv6_wkv"} if arch == "rwkv6-3b" else {"flash_attention"})
    if mode == "train":
        want |= {f"{k}_bwd" for k in want}
    assert set(meta["kernels"]) == set(cpu["kernels"]) == want
    for name, k in meta["kernels"].items():
        # the calls by their operands (deepseek's MTP layer runs at S - 1)
        costs = [(_kernel_cost(name, c["operands"]), c["calls"])
                 for c in k["operands"]]
        assert sum(n for _, n in costs) == k["calls"]
        assert k["flops_by_type"] == {"float32": sum(
            one["flops"]["float32"] * n for one, n in costs)}
        assert k["bytes"] == sum(one["bytes"] * n for one, n in costs)
        # the CPU ran the plain version as often, forward and backward
        assert cpu["kernels"][name]["calls"] == k["calls"]


def test_causal_pairs_closed_form():
    for skv in list(range(1, 41)) + [63, 64, 65, 1023, 1024]:
        for sq in range(1, skv + 1):
            loop = sum(min(skv, r + skv - sq + 1) for r in range(sq))
            assert fa.causal_pairs(sq, skv) == loop, (sq, skv)
            assert fa.causal_pairs(sq, skv, causal=False) == sq * skv


def test_meta_dry_run_launches_nothing_and_loads_neither_jax_nor_repro():
    """The twin of test_port_loads_neither_jax_nor_repro for the dry run:
    a fresh interpreter dry-runs a reduced cell of each kernel family on
    meta (train, so forwards and backwards) and reads the launch
    counters and sys.modules."""
    code = """
import dataclasses, json, sys
from repro_torch import configs
from repro_torch.kernels import flash_attention, mamba2_ssd, rwkv6_wkv
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
calls = {}
for arch in ("zamba2-2.7b", "rwkv6-3b"):
    red = configs.get_reduced(arch)
    fields = {f.name: getattr(red, f.name)
              for f in dataclasses.fields(red) if f.name != "name"}
    rec = dryrun.run_cell(arch, ShapeConfig("t", 16, 2, "train"),
                          overrides=fields, save=False, verbose=False)
    calls.update({k: v["calls"] for k, v in rec["kernels"].items()})
launches = {**flash_attention.launches, **mamba2_ssd.launches,
            **rwkv6_wkv.launches}
print(json.dumps({"calls": calls, "launches": launches,
                  "jax": "jax" in sys.modules,
                  "repro": any(m == "repro" or m.startswith("repro.")
                               for m in sys.modules)}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["calls"] == {"flash_attention": 2, "flash_attention_bwd": 2,
                            "mamba2_ssd": 4, "mamba2_ssd_bwd": 4,
                            "rwkv6_wkv": 2, "rwkv6_wkv_bwd": 2}
    assert set(got["launches"].values()) == {0}
    assert not got["jax"] and not got["repro"]


def _remat_calls(cfg) -> dict:
    """The kernels' calls in one train step under remat "full", rewritten
    from chip_smoke.py's `_train_launches_want` for one step: a
    checkpointed layer runs its forward twice and its backward once;
    zamba2's remat nests (each Mamba2 layer's forward three times, the
    shared block's twice a group); deepseek-v3's MTP layer runs outside
    the stack (once each way); each of `accum_steps` microbatches runs it
    all."""
    n, micro = cfg.n_layers, max(cfg.accum_steps, 1)
    if cfg.block_kind == "rwkv6":
        calls = {"rwkv6_wkv": 2 * n, "rwkv6_wkv_bwd": n}
    elif cfg.shared_attn_every:
        g = n // cfg.shared_attn_every
        calls = {"mamba2_ssd": 3 * n, "mamba2_ssd_bwd": n,
                 "flash_attention": 2 * g, "flash_attention_bwd": g}
    else:
        mtp = 1 if cfg.mtp_depth else 0
        calls = {"flash_attention": 2 * n + mtp,
                 "flash_attention_bwd": n + mtp}
    return {k: v * micro for k, v in calls.items()}


@pytest.mark.parametrize("arch", ["starcoder2-3b", "zamba2-2.7b", "rwkv6-3b",
                                  "phi-3-vision-4.2b", "musicgen-large",
                                  "dbrx-132b", "deepseek-v3-671b"])
def test_train_step_kernel_calls_follow_the_remat_rule(arch):
    """The seven archs chip_smoke.py trains, at their reduced depth with
    remat "full" and the accum_steps its train phase runs (the published
    one; 1 for the MoE archs), on meta."""
    accum = 1 if arch in ("dbrx-132b", "deepseek-v3-671b") else (
        configs.get(arch).accum_steps)
    cfg = configs.get_reduced(arch).replace(
        remat=True, remat_policy="full", accum_steps=accum)
    micro = max(cfg.accum_steps, 1)
    shape = ShapeConfig("t", S, 2 * micro, "train")
    opt_cfg = AdamWConfig(moments_dtype=cfg.moments_dtype)
    got = cost.analyze(make_train_step(cfg, opt_cfg),
                       *specs.cell_arguments(cfg, shape, opt_cfg))
    calls = {k: v["calls"] for k, v in got["kernels"].items()}
    assert calls == _remat_calls(cfg)


def test_peak_of_a_checkpointed_mlp():
    """The peak of live storages, reckoned by hand for a two-layer MLP
    whose first layer is checkpointed (f32, N 3, D 5, F 7: x [N, D], w1
    [D, F], w2 [F, D]; 84 bytes an [N, F], 140 a weight)."""
    n, d, f = 3, 5, 7
    x = torch.empty(n, d, device="meta")
    w1 = torch.empty(d, f, device="meta", requires_grad=True)
    w2 = torch.empty(f, d, device="meta", requires_grad=True)

    def step(w1, w2, x):
        h = checkpoint(lambda x: torch.tanh(x @ w1), x, use_reentrant=False)
        loss = (h @ w2).sum()
        return torch.autograd.grad(loss, (w1, w2))

    got = cost.analyze(step, w1, w2, x)
    start = 4 * (n * d + d * f + f * d)
    assert got["start_bytes"] == start
    # The peak falls in the checkpointed layer's backward, when its
    # recompute has made x @ w1 (84) and tanh of it (84) and the tanh
    # backward has not yet run: alive beside the arguments are h (84,
    # saved by the second product), the loss (4), autograd.grad's seed
    # (4, held until it returns), the second product's gradients dh (84)
    # and dw2 (140), and the recompute's two [N, F] tensors.  The first
    # forward's x @ w1 was freed once tanh had run (the checkpoint saves
    # nothing of the layer), as was h @ w2 once summed.
    assert got["peak_bytes"] == start + 84 + 4 + 4 + 84 + 140 + 84 + 84
    assert got["flops"] == 2 * (2 * n * d * f) * 3   # 6 products of n d f


def test_out_dtype_products_are_counted_at_their_operands_type():
    """The MoE's bf16 products with an f32 result (`aten.bmm.dtype`,
    `aten.mm.dtype`, which the library's formula refuses) count at bf16,
    and meta takes the card's product, not the CPU's f32 copies."""
    a = torch.empty(4, 8, 16, dtype=torch.bfloat16, device="meta")
    b = torch.empty(4, 16, 32, dtype=torch.bfloat16, device="meta")
    from repro_torch.models.moe import _mm_f32
    got = cost.analyze(_mm_f32, a, b)
    assert got["flops_by_type"] == {"bfloat16": 2 * 4 * 8 * 16 * 32}
    assert "aten._to_copy" not in got["op_histogram"]
    got = cost.analyze(_mm_f32, a[0], b[0])
    assert got["flops_by_type"] == {"bfloat16": 2 * 8 * 16 * 32}


def test_a_product_with_no_formula_raises():
    a = torch.empty(8, 16, device="meta")
    with pytest.raises(NotImplementedError, match="no flop formula"):
        cost.analyze(torch.mv, a, torch.empty(16, device="meta"))


def test_device_rule():
    """meta takes the LM kernels' route and is refused by the GP kernels;
    any device other than CPU, CUDA and meta raises."""
    x = torch.empty(3, 4, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.gp_kernel_matrix(x, x, torch.empty(4, device="meta"),
                             torch.empty((), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        gp_kernel.gp_kernel_matrix(x, x, torch.empty(4, device="meta"),
                                   torch.empty((), device="meta"))
    q = torch.empty(1, 8, 2, 16, device="meta")
    assert ops.flash_attention(q, q, q).device.type == "meta"
    with pytest.raises(ValueError, match="no route"):
        ops._on_cpu(types.SimpleNamespace(device=torch.device("xla")))


def test_the_meta_route_keeps_the_cards_checks():
    """A meta call is refused where the card's would be, with the
    wrapper's own message."""
    q = torch.empty(1, 8, 2, 300, device="meta")
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.empty(1, 8, 65536, 16, device="meta")
    with pytest.raises(ValueError, match="65535"):
        fa.flash_attention(q, q, q)
    x = torch.empty(1, 8, 2, 4, device="meta")
    with pytest.raises(ValueError, match="state width"):
        ssd.mamba2_ssd(x, torch.empty(1, 8, 2, device="meta"),
                       torch.empty(2, device="meta"),
                       *(torch.empty(1, 8, 200, device="meta"),) * 2,
                       torch.empty(2, device="meta"))


def test_meta_outputs_and_scratch_are_the_cards():
    """On meta a wrapper allocates what it allocates on the card: the
    backward's scratch sized by the Python twins of the library's rules."""
    b, s, h, hkv, dh, dv = 2, 128, 24, 2, 128, 128
    q = torch.empty(b, s, h, dh, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, s, hkv, dh, dtype=torch.bfloat16, device="meta")
    v = torch.empty(b, s, hkv, dv, dtype=torch.bfloat16, device="meta")
    got = cost.analyze(fa.flash_attention_bwd, q, k, v,
                       torch.empty(b, s, h, dv, dtype=torch.bfloat16,
                                   device="meta"),
                       torch.empty(b, h, s, device="meta"),
                       torch.empty(b, s, h, dv, dtype=torch.bfloat16,
                                   device="meta"))
    splits = fa.splits_rule(b, s, h, hkv, dh, dv, torch.bfloat16)
    assert splits == fa.bwd_splits(q, k, v) > 1
    scratch = 4 * (b * h * s + splits * b * s * hkv * (dh + dv))
    assert scratch == 4 * fa.bwd_scratch(q, k, v)
    assert got["peak_bytes"] - got["start_bytes"] == (
        2 * (q.numel() + k.numel() + v.numel()) + scratch)
    assert got["kernels"]["flash_attention_bwd"]["calls"] == 1


def _reduced_overrides(arch: str) -> dict:
    red = configs.get_reduced(arch)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name != "name"}


RECORD_KEYS = {"arch", "shape", "mesh", "tag", "overrides", "device",
               "status", "flops", "flops_by_type", "flops_outside_kernels",
               "bytes", "collective_bytes", "collectives", "kernels",
               "roofline", "argument_bytes", "peak_bytes", "fits_h100_80g",
               "active_params", "model_flops", "useful_flops_ratio",
               "op_histogram", "bytes_by_opcode"}


@pytest.mark.parametrize("arch", ["rwkv6-3b", "starcoder2-3b"])
def test_cell_records_have_every_key(arch):
    """run_cell over the four published shapes at a reduced arch's widths:
    every record ok (long_500k skipped for the full-attention arch), with
    every key, its roofline terms and its prior."""
    for shape in configs.shapes():
        rec = dryrun.run_cell(arch, shape.name,
                              overrides=_reduced_overrides(arch),
                              save=False, verbose=False)
        json.dumps(rec)
        if shape.name == "long_500k" and arch == "starcoder2-3b":
            assert rec["status"] == "skipped"
            continue
        assert rec["status"] == "ok" and RECORD_KEYS <= set(rec), shape
        roof = rec["roofline"]
        assert {"compute_s", "memory_s", "collective_s", "dominant",
                "roofline_s", "op_sum_s"} <= set(roof)
        assert roof["roofline_s"] == max(roof["compute_s"], roof["memory_s"])
        assert roof["op_sum_s"] >= roof["roofline_s"] * (1 - 1e-12)
        tokens = shape.global_batch * (1 if shape.mode == "decode"
                                       else shape.seq_len)
        assert rec["model_flops"] == ((6 if shape.mode == "train" else 2)
                                      * rec["active_params"] * tokens)
        prior = hlo_runtime_prior(cost.op_cost(rec),
                                  peak_flops=cost.prior_peak_flops(rec),
                                  mem_bw=cost.HBM_BYTES_PER_S)
        assert prior == pytest.approx(roof["roofline_s"] + 1e-4, rel=1e-9)
        spec = calibrate([], backends.get("hq"), priors={arch: prior})
        assert spec.runtime_fit(arch).median == prior


def test_dry_run_refuses_the_reference_meshes(monkeypatch, capsys):
    for mesh in ("single", "multi"):
        monkeypatch.setattr(sys, "argv", [
            "dryrun", "--arch", "rwkv6-3b", "--shape", "train_4k", "--mesh",
            mesh])
        with pytest.raises(SystemExit, match="16b"):
            dryrun.main()
