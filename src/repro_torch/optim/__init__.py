"""AdamW and int8 gradient compression (`repro/optim`), on dicts of
tensors."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     cosine_schedule, global_norm,
                                     init_opt_state)
from repro_torch.optim.compression import (CompressionState,
                                           compress_with_feedback,
                                           init_compression_state)

__all__ = ["AdamWConfig", "adamw_update", "cosine_schedule", "global_norm",
           "init_opt_state", "CompressionState", "compress_with_feedback",
           "init_compression_state"]
