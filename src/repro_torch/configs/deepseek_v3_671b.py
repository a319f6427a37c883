"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H d_ff=2048(per routed expert) vocab=129280
MoE 256e top-8 [arXiv:2412.19437; hf].  MLA dims per the paper: q_lora=1536,
kv_lora=512, qk_nope=128, qk_rope=64, v_head=128.  First 3 layers dense with
d_ff=18432.  MTP depth 1.  bf16 optimizer moments + ZeRO over the pod axis so
the 671B state fits 16 GB/chip (recorded in EXPERIMENTS.md §Dry-run).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    attn_kind="mla",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,
    first_k_dense=3,
    dense_d_ff=18432,
    router_kind="sigmoid",
    mtp_depth=1,
    fsdp_pod=True,
    moments_dtype="bfloat16",
    accum_steps=8,
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128,
    q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, n_experts=4, moe_top_k=2, moe_d_ff=64, first_k_dense=1,
    dense_d_ff=128, fsdp_pod=False, moments_dtype="float32",
    dtype="float32", remat=False, accum_steps=1,
)
