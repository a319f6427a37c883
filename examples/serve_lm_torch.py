"""LM serving through the PyTorch port's scheduler (mixed-cost decode
requests), the twin of examples/serve_lm.py.

    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --arch rwkv6-3b
    PYTHONPATH=src python examples/serve_lm_torch.py --arch zamba2-2.7b --full

Variable-length prompts are dispatched to persistent model servers (the
weights stay on the device) and to naive per-request servers (each
request draws its weights anew).  `--full` serves the published widths
(zamba2-2.7b: 54 layers, d_model 2560; rwkv6-3b: 32 layers, d_model 2560;
bf16, random weights), which wants a card; the default is the reduced
smoke config.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch import configs
from repro_torch import device
from repro_torch.launch.serve import serve_benchmark


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b",
                    choices=list(configs.ARCH_NAMES))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    device.set_device(args.device)
    device.strict_numerics()

    for persistent in (True, False):
        out = serve_benchmark(args.arch, n_requests=args.requests,
                              max_new=args.max_new, n_workers=args.workers,
                              persistent=persistent,
                              max_len=2048 if args.full else 128,
                              reduced=not args.full)
        s = out["summary"]
        mode = "persistent (HQ)" if persistent else "per-request (naive)"
        print(f"{mode:22s}: wall {out['wall']:6.2f}s  "
              f"cpu {s.total_cpu_time:6.2f}s  "
              f"{out['tokens']} tokens generated on {args.device}")


if __name__ == "__main__":
    main()
