"""Model / workload configuration dataclasses.

A single ``ModelConfig`` describes every architecture family in the assigned
pool (dense GQA, MLA, MoE, SSM, RWKV, hybrid, audio/vlm-backbone).  Family
specific fields are simply unused by the other families.  ``ShapeConfig``
describes one (seq_len, global_batch, mode) workload cell.

The port's own copy of `repro/models/config.py`: the same fields and
defaults, with `activation_dtype` a `torch.dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


# The four LM shapes assigned to every architecture in the pool.
LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # --- block layout -------------------------------------------------
    # Per-layer block kind.  "attn+mlp" is a standard transformer layer;
    # "mamba2" an SSM block; "rwkv6" an RWKV time/channel-mix pair.
    block_kind: str = "attn+mlp"
    attn_kind: str = "gqa"            # gqa | mla | none
    mlp_kind: str = "swiglu"          # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # hybrid (zamba2): a weight-shared attention block applied every
    # `shared_attn_every` SSM layers.
    shared_attn_every: int = 0

    # --- MLA ------------------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden size
    first_k_dense: int = 0            # leading dense layers (deepseek-v3: 3)
    dense_d_ff: int = 0               # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_kind: str = "softmax"      # softmax | sigmoid (deepseek-v3)

    # --- SSM (mamba2) -----------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- RWKV6 ------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # --- MTP (deepseek-v3) -------------------------------------------------
    mtp_depth: int = 0

    # --- IO ------------------------------------------------------------
    input_mode: str = "tokens"        # tokens | embeddings (audio/vlm stubs)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # --- numerics / distribution knobs ----------------------------------
    dtype: str = "bfloat16"
    accum_steps: int = 1              # gradient-accumulation microbatches
    moments_dtype: str = "float32"    # adam moment dtype (bf16 for huge models)
    fsdp_pod: bool = False            # shard params over pod axis too (ZeRO over DCN)
    remat: bool = True
    remat_policy: str = "full"        # full | dots (save matmul outputs:
                                      # backward skips recompute AND its
                                      # FSDP weight re-gathers)
    scan_layers: bool = True
    # beyond-paper perf knobs (§Perf hillclimb; False = paper-faithful
    # baseline distribution):
    seq_shard: bool = False           # Megatron-style sequence parallelism:
                                      # shard activation S over `model`
    ep_over_data: bool = False        # EP over data x model (1 expert/chip;
                                      # token all-gather instead of per-step
                                      # FSDP weight gathers — decode/serving)
    subquadratic: bool = False        # True -> long_500k cell is runnable
    vocab_pad_multiple: int = 128

    # ---------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def shapes(self) -> Tuple[ShapeConfig, ...]:
        return LM_SHAPES

    def runnable(self, shape: ShapeConfig) -> bool:
        """long_500k requires sub-quadratic attention (SSM/hybrid/linear)."""
        if shape.name == "long_500k" and not self.subquadratic:
            return False
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
