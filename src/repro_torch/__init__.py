"""PyTorch port of `repro`: the GS2 -> GP -> queue re-costing path, the
scheduler, and the LM substrate (serving and training).

Mirrors `repro`'s layout module for module.  Tensors live on the device
chosen through `repro_torch.device` (CUDA unless the caller asks for the
CPU); the kernels are hand-written CUDA for Hopper
(`repro_torch.kernels`), with plain PyTorch versions beside them in
`repro_torch.kernels.ref`.
"""
