"""What the full-depth starcoder2-3b train step costs on the card right
after the dense serve paths have run in the same process, against the
same step on an emptied caching allocator.  A profiling aid beside
chip_smoke.py; the port never imports it.

    python3 train_step_context.py          # from the repo root, on a card
    python3 train_step_context.py --src DIR --contexts clean,clean

In one process: chip_smoke's device and build phases, then train runs
in the order `--contexts` gives (default: clean, after serving, after
serving, clean).  A clean
run empties the caching allocator (`torch.cuda.empty_cache()`) and calls
chip_smoke's full-depth train run (`_train_full_depth`: 30 layers, bf16,
remat, 6 AdamW steps at B 2, S 1024, launch counts asserted); a run after
serving first drives chip_smoke's serve phase for qwen3-14b and
minicpm3-4b (8 persistent and 2 fresh-server requests each, the cache
left as the phase leaves it) and then the same train run.  Each run
gives the step ms (median of the last 4), the reserved GiB at its start,
the caching allocator's device allocations, frees and retries during
the steps, and one more step profiled (wall, device busy ms, idle).
`--src DIR` runs DIR/src's package in place of this checkout's (its
kernels built under DIR/build), with this checkout's chip_smoke.py: a
parent commit unpacked with `git archive` into a directory `.gitignore`
lists, for a parent-against-change comparison of the step alone.

Prints one JSON line per run and writes them all to
`chiprun_out/train_step_context[_<name of DIR>].json`.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke

CONTEXTS = ("clean", "after_serve")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=None,
                    help="a checkout whose src/ package is measured")
    ap.add_argument("--contexts", default="clean,after_serve,after_serve,"
                    "clean", help="comma-separated: clean or after_serve")
    args = ap.parse_args()
    contexts = args.contexts.split(",")
    if not set(contexts) <= set(CONTEXTS):
        ap.error(f"--contexts takes {CONTEXTS}")
    if args.src is not None:
        sys.path.insert(0, str(args.src.resolve() / "src"))
    import torch
    import repro_torch
    name, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    runs = []
    for context in contexts:
        if context == "clean":
            torch.cuda.empty_cache()
        else:
            for arch in chip_smoke.DENSE_ARCHS:
                chip_smoke.phase_serve(arch, ("flash_attention",))
        res, _ = chip_smoke._train_full_depth()
        p = res["profiled_step"]
        row = dict(context=context,
                   step_ms_median_last4=res["step_ms_median_last4"],
                   step_s=res["step_s"],
                   reserved_gib_at_start=res["reserved_gib_at_start"],
                   allocator=res["allocator"],
                   peak_device_gib=res["peak_device_gib"],
                   profiled_wall_ms=p["wall_ms"],
                   profiled_busy_ms=p["device_busy_ms"],
                   profiled_idle_share=p["device_idle_share"])
        runs.append(row)
        print(json.dumps(row), flush=True)
    out_dir = chip_smoke.ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    suffix = f"_{args.src.resolve().name}" if args.src is not None else ""
    (out_dir / f"train_step_context{suffix}.json").write_text(json.dumps(
        dict(device=name, nvidia_smi=smi, package=repro_torch.__file__,
             runs=runs), indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
