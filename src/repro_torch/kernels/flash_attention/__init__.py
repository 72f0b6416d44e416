from repro_torch.kernels.flash_attention.kernel import cost
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_forward,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    flash_attention_bwd_ref,
    lse_ref,
)

__all__ = [
    "cost",
    "attention_ref",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_ref",
    "flash_attention_fwd",
    "flash_forward",
    "lse_ref",
]
