"""Train a ~100M-parameter LM for a few hundred steps through the PyTorch
port, the twin of examples/train_lm.py.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

The port's training path on one device: seeded init, synthetic pipeline,
the eager train step (attention forward and backward through the CUDA
kernels on a card, the plain versions on the CPU), async checkpoints with
restore.  The reference scales a qwen3-family model; this one scales
starcoder2-3b (GQA, RoPE, gelu MLP) to ~100M parameters.  Checkpoints go under build/.
zamba2-2.7b trains through `python -m repro_torch.launch.train --arch
zamba2-2.7b`, its Mamba2 SSD forward and backward through the CUDA
kernels on a card.
"""
import argparse
import sys
import types
from pathlib import Path

sys.path.insert(0, "src")

from repro_torch import configs
from repro_torch import device
from repro_torch.launch.train import train
from repro_torch.models import model as model_lib

ROOT = Path(__file__).resolve().parents[1]


def lm100m():
    return configs.get("starcoder2-3b").replace(
        name="starcoder2-100m",
        n_layers=10, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=32000, dtype="float32", remat=False,
        accum_steps=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" / "lm100m_torch"))
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args()
    device.set_device(args.device)

    cfg = lm100m()
    n = model_lib.count_params(cfg)
    print(f"training {cfg.name}: {n / 1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")

    # register the custom config so the standard driver can use it
    mod = types.ModuleType("lm100m_torch_cfg")
    mod.CONFIG = cfg
    mod.REDUCED = cfg
    sys.modules["lm100m_torch_cfg"] = mod
    configs._MODULES["starcoder2-100m"] = "lm100m_torch_cfg"

    out = train("starcoder2-100m", reduced=False, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=100, log_every=20)
    print(f"\nloss: {out['first_loss']:.4f} -> {out['last_loss']:.4f} "
          f"(improvement {(out['first_loss'] - out['last_loss']):.4f})")


if __name__ == "__main__":
    main()
