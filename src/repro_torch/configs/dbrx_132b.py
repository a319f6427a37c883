"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752(per expert) vocab=100352
MoE 16e top-4 [hf:databricks/dbrx-base; unverified].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    moe_top_k=4,
    moe_d_ff=10752,
    rope_theta=500_000.0,
    fsdp_pod=True,
    accum_steps=4,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=128, n_experts=4, moe_top_k=2, moe_d_ff=128, fsdp_pod=False,
    dtype="float32", remat=False, accum_steps=1,
)
