"""PyTorch port of `repro`: the GS2 -> GP -> queue re-costing path.

Mirrors `repro`'s layout module for module.  Tensors live on the device
chosen through `repro_torch.device` (CUDA unless the caller asks for the
CPU); the three GP kernels are hand-written CUDA for Hopper
(`repro_torch.kernels.gp_kernel`), with plain PyTorch versions beside
them in `repro_torch.kernels.ref`.
"""
