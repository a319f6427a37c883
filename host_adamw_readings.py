"""Host seconds of the AdamW stage of deepseek-v3-671b's f32 card-vs-CPU
step (chip_smoke.py's `_train_step_grads` at DEEPSEEK_CPU_CUT, 3.48 B
parameters): the port's `adamw_update` on the host at several slice
sizes (`optim.adamw._HOST_SLICE`: 2^26, the card's, down to 2^18), each
with its `init_opt_state`, the global norm alone, and the updated
parameters' largest gap read on the host or on the card.  A measurement
aid beside chip_smoke.py; the port never imports it.

    python3 host_adamw_readings.py        # from the repo root, on a card

Prints one line per reading and writes them to
`chiprun_out/host_adamw_readings.json`.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.optim import adamw
    if not torch.cuda.is_available():
        print("host_adamw_readings.py needs a CUDA card", file=sys.stderr)
        return 1
    out = {"threads": torch.get_num_threads()}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        print(f"{name} {out[name]:.3f} s", flush=True)
        return res

    cfg = configs.get(chip_smoke.DEEPSEEK_TRAIN_ARCH).replace(
        dtype="float32", **chip_smoke.DEEPSEEK_CPU_CUT)
    m = timed("init_params", lambda: model.init_params(cfg, 7, "cpu"))
    named = dict(m.named_parameters())
    grads = {k: p.detach() * 1e-3 for k, p in named.items()}
    opt_cfg = adamw.AdamWConfig()
    timed("global_norm", lambda: adamw.global_norm(grads))
    for size in (1 << 26, 1 << 22, 1 << 20, 1 << 18):
        adamw._HOST_SLICE = size
        state = timed(f"init_opt_state {size}",
                      lambda: adamw.init_opt_state(named, opt_cfg))
        for i in (1, 2):
            timed(f"adamw_update {size} #{i}", lambda: adamw.adamw_update(
                named, grads, state, opt_cfg))
        del state
    card = [p.detach().cuda() for p in named.values()]
    on_host = timed("param_gap on the host", lambda: max(
        float((a.cpu() - b.detach()).abs().max())
        for a, b in zip(card, named.values())))
    on_card = timed("param_gap on the card", lambda: max(
        float((a - b.detach().cuda()).abs().max())
        for a, b in zip(card, named.values())))
    out["param_gap_equal"] = on_host == on_card
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "host_adamw_readings.json").write_text(json.dumps(out,
                                                                 indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
