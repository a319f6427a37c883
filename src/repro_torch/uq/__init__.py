"""UQ substrate on PyTorch: GS2 proxy, GP surrogate and its engines,
quasilinear QoI integral, samplers."""
from repro_torch.uq.engine import (BACKENDS, ExactEngine, IncrementalEngine,
                                   PartitionedEngine, SurrogateEngine,
                                   as_engine, fit_engine, wrap_posterior)
from repro_torch.uq.sampling import GS2_PARAM_RANGES, halton, latin_hypercube
