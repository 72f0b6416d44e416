"""AdamW with low-precision moment options (the reference's `repro.optim`)."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    warmup_cosine,
)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "warmup_cosine"]
