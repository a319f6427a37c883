"""Hand-written Hopper kernels for the GP path (`gp_kernel`), their plain
PyTorch versions (`ref`) and the dispatcher between them (`ops`)."""
