"""The language-model stack: configs in, logits and decode caches out.

gemma3-1b (GQA, 5 local : 1 global sliding-window layers, SwiGLU),
moonshot-v1-16b-a3b (MHA with a top-6 of 64 mixture of experts),
mamba2-1.3b (SSD) and zamba2-7b (mamba with a shared attention block)
run end to end; their prefill attention, decode MLP and short conv go
through the hand-written CUDA kernels on the card (the experts are
batched `torch.bmm`, as the reference leaves them to XLA).  `lm_loss`
trains the attention stacks through the flash forward and backward
kernels.
"""

from repro_torch.models.lm import (
    LM,
    init_lm,
    lm_decode_step,
    lm_logits,
    lm_loss,
    lm_prefill,
)
from repro_torch.models.moe import Routing, capacity, init_moe, moe_forward, record_routing
from repro_torch.models.weights import from_jax

__all__ = ["LM", "Routing", "capacity", "from_jax", "init_lm", "init_moe", "lm_decode_step",
           "lm_logits", "lm_loss", "lm_prefill", "moe_forward", "record_routing"]
