"""zamba2-2.7b [hybrid] — Mamba2 backbone + weight-shared attention blocks.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf].  One shared transformer block (attn + MLP, single
weight copy) applied after every 6 Mamba2 layers.  Sub-quadratic: long_500k
RUNS (SSM state is O(1); the shared-attn KV caches at 524288 x batch 1 are
sequence-sharded over the model axis).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    block_kind="mamba2",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,           # d_inner=5120 -> 80 ssd heads
    ssm_expand=2,
    shared_attn_every=6,
    subquadratic=True,
    accum_steps=1,
)

REDUCED = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=32, shared_attn_every=2,
    dtype="float32", remat=False,
)
