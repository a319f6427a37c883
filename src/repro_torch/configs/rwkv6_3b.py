"""rwkv6-3b [ssm] — Finch, attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536 [arXiv:2404.05892; hf].
Sub-quadratic: the long_500k cell RUNS for this arch (O(1) recurrent state).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    block_kind="rwkv6",
    attn_kind="none",
    n_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_dim=64,          # 40 heads
    rwkv_decay_lora=64,
    rwkv_mix_lora=32,
    subquadratic=True,
    accum_steps=1,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=128, d_ff=256, vocab_size=128, rwkv_head_dim=32,
    rwkv_decay_lora=16, rwkv_mix_lora=8, dtype="float32", remat=False,
)
