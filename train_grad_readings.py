"""Per-tensor gradient readings of one f32 train step at full width
(chip_smoke.py's card-vs-CPU step), over several seeds: starcoder2-3b 2
layers deep, zamba2-2.7b one group (6 layers) deep, rwkv6-3b,
phi-3-vision-4.2b or musicgen-large 2 layers deep (the last two on
embeddings), dbrx-132b 1 layer deep with 8 of its 16 experts, or
deepseek-v3-671b 1 layer deep (its MoE layer) with 16 of its 256 experts
and its MTP block.  These are the readings from which chip_smoke.py's
limits TRAIN_GRAD_LIMITS, ZAMBA_GRAD_LIMITS, RWKV_GRAD_LIMITS,
PHI3_GRAD_LIMITS, MUSICGEN_GRAD_LIMITS, DBRX_GRAD_LIMITS and
DEEPSEEK_GRAD_LIMITS are set.  A measurement aid beside chip_smoke.py;
the port never imports it.

    python3 train_grad_readings.py                  # from the repo root, on a card
    python3 train_grad_readings.py --seeds 7:9 11:13
    python3 train_grad_readings.py --arch zamba2-2.7b
    python3 train_grad_readings.py --arch rwkv6-3b
    python3 train_grad_readings.py --arch phi-3-vision-4.2b
    python3 train_grad_readings.py --arch musicgen-large
    python3 train_grad_readings.py --arch dbrx-132b
    python3 train_grad_readings.py --arch deepseek-v3-671b

For each `params:tokens` seed pair it runs `chip_smoke._train_step_grads`
(the card, the card with TF32 GEMMs as a control of lower precision, the
port on the CPU in f32, and the same model in float64 on the CPU) and
records each tensor's relative L2 gap of the card's gradient to the
CPU's and of both to float64, the control's gap to the CPU's, whether
the card's gradient repeats bit for bit, and for an MoE arch the routing
differences of the card, the control and float64 from the CPU, and the
host's seconds by stage.  The summary gives, per
tensor, the largest card-vs-CPU gap over the seeds and the smallest gap
the control reads.  Prints one JSON line per seed and the summary, and
writes everything to `chiprun_out/train_grad_readings.json`
(`train_grad_readings_<arch>.json` for the other archs).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", nargs="+", default=["7:9", "11:13", "17:19"],
                    help="params:tokens seed pairs")
    two = dict(n_layers=chip_smoke.TRAIN_CPU_LAYERS)
    cuts = {chip_smoke.TRAIN_ARCH: two,
            chip_smoke.ZAMBA_TRAIN_ARCH: dict(
                n_layers=chip_smoke.ZAMBA_CPU_LAYERS),
            chip_smoke.RWKV_TRAIN_ARCH: dict(
                n_layers=chip_smoke.RWKV_CPU_LAYERS),
            chip_smoke.PHI3_TRAIN_ARCH: two,
            chip_smoke.MUSICGEN_TRAIN_ARCH: two,
            chip_smoke.DBRX_TRAIN_ARCH: chip_smoke.DBRX_CPU_CUT,
            chip_smoke.DEEPSEEK_TRAIN_ARCH: chip_smoke.DEEPSEEK_CPU_CUT}
    ap.add_argument("--arch", default=chip_smoke.TRAIN_ARCH,
                    choices=tuple(cuts))
    args = ap.parse_args()
    cut = cuts[args.arch]
    import torch
    from repro_torch import device
    if not torch.cuda.is_available():
        print("train_grad_readings.py needs a CUDA card", file=sys.stderr)
        return 1
    device.strict_numerics()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    runs = []
    for pair in args.seeds:
        seed, tok_seed = (int(x) for x in pair.split(":"))
        r = chip_smoke._train_step_grads(seed, tok_seed, repeat=True,
                                         arch=args.arch, cut=cut)
        r.update(seed=seed, tok_seed=tok_seed)
        runs.append(r)
        print(json.dumps(dict(seed=seed, tok_seed=tok_seed,
                              metrics=r["metrics"],
                              repeat_bitwise=r["repeat_bitwise"],
                              routing=r["routing"],
                              max_param_err=r["max_param_err"],
                              host_s=r["host_s"],
                              host_mem_available_gib=r[
                                  "host_mem_available_gib"],
                              host_peak_rss_gib=r["host_peak_rss_gib"])),
              flush=True)
    summary = {}
    for k in runs[0]["tensors"]:
        t = [r["tensors"][k] for r in runs]
        summary[k] = dict(card_cpu_max=max(x["card_cpu"] for x in t),
                          tf32_cpu_min=min(x["tf32_cpu"] for x in t),
                          card_f64_max=max(x["card_f64"] for x in t),
                          cpu_f64_max=max(x["cpu_f64"] for x in t))
        print(f"{k:32s} " + " ".join(f"{n}={v:.3e}"
                                     for n, v in summary[k].items()))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = ("train_grad_readings.json" if args.arch == chip_smoke.TRAIN_ARCH
            else f"train_grad_readings_{args.arch}.json")
    (out_dir / name).write_text(json.dumps(
        dict(device=smi, arch=args.arch, cut=cut, runs=runs,
             summary=summary), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
