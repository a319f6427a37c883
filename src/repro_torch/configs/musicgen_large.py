"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf].  The EnCodec/text frontend is a STUB per the brief:
`input_specs()` provides precomputed frame embeddings [B,S,D]; the backbone
(this config) is the deliverable.  Hardware adaptation: sinusoidal positions
replaced by RoPE (framework standard), gelu MLP kept.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_kind="gelu",
    input_mode="embeddings",
    accum_steps=2,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128,
    dtype="float32", remat=False, accum_steps=1,
)
