"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend.

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct; hf].  The CLIP vision tower is a
STUB per the brief: `input_specs()` provides precomputed patch+text
embeddings [B,S,D]; this config is the transformer backbone.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    input_mode="embeddings",
    accum_steps=1,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128,
    dtype="float32", remat=False,
)
