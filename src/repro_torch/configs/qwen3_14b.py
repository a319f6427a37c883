"""qwen3-14b [dense] — qk_norm, GQA.

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936 [hf:Qwen/Qwen3-8B; hf].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    accum_steps=2,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=128, dtype="float32", remat=False, accum_steps=1,
)
