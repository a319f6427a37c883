"""The LM substrate on PyTorch: config, layers, GQA attention, the Mamba2
block and the model composition (`repro/models` in the reference), plus
`weights` to carry a reference parameter tree across."""
