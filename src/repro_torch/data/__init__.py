"""Token data pipeline (`repro/data`): a deterministic synthetic LM
stream and a memmap corpus, in numpy."""
from repro_torch.data.pipeline import (MemmapCorpus, SyntheticLM,
                                       host_shard, make_pipeline)

__all__ = ["MemmapCorpus", "SyntheticLM", "host_shard", "make_pipeline"]
