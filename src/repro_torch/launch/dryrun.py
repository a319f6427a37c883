"""Dry run of every (arch x shape) cell on one H100 (the port of
`repro/launch/dryrun.py`, its one-device half).

For each cell this builds the cell's arguments on the `meta` device
(`launch.specs`) and runs the real step function once (the train step
for train shapes, the prefill or decode step otherwise) under the cost
analysis (`launch.cost`): no tensor is allocated, no kernel is built or
launched, and no card is needed.  It records:
  * flops by type and bytes, with the LM kernels' calls, flops and bytes;
  * the roofline terms on the H100 (`cost.DEVICE`): compute as the sum
    over types of flops over that type's peak, memory as bytes over HBM's
    rate, collectives 0 (one device), the dominant term, and the sum over
    ops of each op's own max(flops / peak, bytes / rate);
  * the arguments' bytes and the peak of live device bytes, and whether
    the peak fits the card's 80 GiB;
  * the model's flops (6 x active parameters x tokens to train, 2 x to
    serve) and their share of the counted flops.
A cell the kernels cannot run (a wrapper's check refuses its operands) is
recorded as `failed` with the wrapper's message; long_500k is `skipped`
for the archs without sub-quadratic attention, as in the reference.

Results land in experiments/dryrun_torch/<arch>__<shape>__one.json.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh one

The reference's `single` and `multi` meshes (256 and 512 devices) are mesh
code, still to be ported (ROADMAP.md Queue 1 item 16b).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Union

from repro_torch import configs
from repro_torch.launch import cost, specs
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import model as model_lib
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import AdamWConfig

RESULTS_DIR = (Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")
MESH = "one"


def step_for(cfg, shape: ShapeConfig, opt_cfg: AdamWConfig):
    if shape.mode == "train":
        return make_train_step(cfg, opt_cfg)
    if shape.mode == "prefill":
        return make_prefill_step(cfg)
    return make_decode_step(cfg)


def _shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    if isinstance(shape, ShapeConfig):
        return shape
    for s in configs.shapes():
        if s.name == shape:
            return s
    raise KeyError(f"unknown shape {shape!r}; have "
                   f"{[s.name for s in configs.shapes()]}")


def run_cell(arch: str, shape: Union[str, ShapeConfig], *,
             overrides: Optional[dict] = None, tag: str = "",
             save: bool = True, verbose: bool = True) -> dict:
    """The cell's record.  `shape` is a name of `configs.shapes()` or a
    `ShapeConfig` of the caller's; `overrides` replace config fields (a
    depth cut, `accum_steps`); `tag` suffixes the result file so that a
    variant never overwrites the published cell."""
    cfg = configs.get(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = _shape(shape)
    head = {"arch": arch, "shape": shape.name, "mesh": MESH, "tag": tag,
            "overrides": dict(overrides or {}), "device": cost.DEVICE,
            "batch": shape.global_batch, "seq_len": shape.seq_len,
            "mode": shape.mode, "accum_steps": cfg.accum_steps}
    if not cfg.runnable(shape):
        rec = {**head, "status": "skipped",
               "reason": "long_500k requires sub-quadratic attention"}
        if save:
            _save(rec)
        return rec
    opt_cfg = AdamWConfig(moments_dtype=cfg.moments_dtype)
    t0 = time.perf_counter()
    args = specs.cell_arguments(cfg, shape, opt_cfg)
    got = cost.analyze(step_for(cfg, shape, opt_cfg), *args)
    trace_s = time.perf_counter() - t0
    compute_s, memory_s = cost.roofline_s(got["flops_by_type"], got["bytes"])
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": 0.0}
    tokens = shape.global_batch * (1 if shape.mode == "decode"
                                   else shape.seq_len)
    n_active = model_lib.count_active_params(cfg)
    model_flops = (6 if shape.mode == "train" else 2) * n_active * tokens
    rec = {
        **head, "status": "ok", "trace_s": trace_s,
        "flops": got["flops"], "flops_by_type": got["flops_by_type"],
        "flops_outside_kernels": got["flops_outside_kernels"],
        "bytes": got["bytes"], "collective_bytes": 0, "collectives": {},
        "bytes_by_opcode": got["bytes_by_opcode"],
        "kernels": got["kernels"], "op_histogram": got["op_histogram"],
        "roofline": {**terms, "dominant": max(terms, key=terms.get),
                     "roofline_s": max(compute_s, memory_s),
                     "op_sum_s": got["op_roofline_s"]},
        "argument_bytes": got["start_bytes"],
        "peak_bytes": got["peak_bytes"],
        "fits_h100_80g": got["peak_bytes"] <= cost.HBM_BYTES,
        "active_params": n_active, "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / got["flops"]
                               if got["flops"] else 0.0),
    }
    if verbose:
        print(f"[{arch} x {shape.name} x {MESH}] trace={trace_s:.1f}s "
              f"flops={got['flops']:.3e} bytes={got['bytes']:.3e} "
              f"peak={got['peak_bytes'] / 2 ** 30:.2f}GiB "
              f"fits80G={rec['fits_h100_80g']} "
              f"dominant={rec['roofline']['dominant']}")
    if save:
        _save(rec)
    return rec


def _path(arch: str, shape: str, tag: str = "") -> Path:
    suffix = f"__{tag}" if tag else ""
    return RESULTS_DIR / f"{arch}__{shape}__{MESH}{suffix}.json"


def _save(rec: dict) -> None:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    _path(rec["arch"], rec["shape"], rec.get("tag", "")).write_text(
        json.dumps(rec, indent=1, default=str))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=MESH,
                    choices=[MESH, "single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()
    if args.mesh != MESH:
        raise SystemExit(f"--mesh {args.mesh}: the reference's 256- and "
                         f"512-device meshes are not ported yet (ROADMAP.md "
                         f"Queue 1 item 16b); the port dry-runs one H100 "
                         f"(--mesh {MESH})")
    if args.all:
        cells = [(a, s.name) for a, s, _run in configs.cells()]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        raise SystemExit("--arch and --shape, or --all")

    failures = []
    for arch, shp in cells:
        out = _path(arch, shp)
        if args.skip_existing and out.exists():
            prev = json.loads(out.read_text())
            if prev.get("status") in ("ok", "skipped"):
                print(f"[{arch} x {shp} x {MESH}] cached: {prev['status']}")
                continue
        try:
            run_cell(arch, shp)
        except (ValueError, RuntimeError) as e:
            # a wrapper's check refusing the cell's operands, or a step the
            # port cannot run at this shape
            traceback.print_exc()
            failures.append((arch, shp, repr(e)))
            _save({"arch": arch, "shape": shp, "mesh": MESH, "tag": "",
                   "device": cost.DEVICE, "status": "failed",
                   "error": str(e)})
    if failures:
        print(f"\n{len(failures)} failed cells:")
        for f in failures:
            print("  ", f)
    print(f"\n{len(cells)} cells: {len(cells) - len(failures)} ok or "
          f"skipped, {len(failures)} failed; records in {RESULTS_DIR}")


if __name__ == "__main__":
    main()
