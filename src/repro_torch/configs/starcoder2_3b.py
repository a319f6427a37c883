"""starcoder2-3b [dense] — GQA, RoPE.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 [arXiv:2402.19173; hf].
gelu two-matrix MLP per the released model.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    mlp_kind="gelu",
    rope_theta=100_000.0,
    accum_steps=1,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=128, dtype="float32", remat=False,
)
