"""The LM substrate on PyTorch: config, layers, GQA and MLA attention, the Mamba2
block and the model composition with its loss (`repro/models` in the
reference), plus `weights` to carry reference parameter and optimizer
trees across and to lay the port's out in the reference's checkpoint
layout."""
