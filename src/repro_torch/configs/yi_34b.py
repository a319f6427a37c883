"""yi-34b [dense] — llama-arch GQA.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 [arXiv:2403.04652; hf].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    accum_steps=4,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=128, dtype="float32", remat=False, accum_steps=1,
)
