"""The training data stream (the reference's `repro.data`)."""

from repro_torch.data.pipeline import DataConfig, Prefetcher, TokenStream

__all__ = ["DataConfig", "Prefetcher", "TokenStream"]
