"""Hand-written Hopper kernels (`gp_kernel`, `flash_attention` with its
backward, `mamba2_ssd`, `rwkv6_wkv`, built by `_build`), their plain
PyTorch versions (`ref`) and the dispatcher between them (`ops`)."""
