"""The language-model stack: configs in, logits and decode caches out.

gemma3-1b (GQA, 5 local : 1 global sliding-window layers, SwiGLU) and
mamba2-1.3b (SSD) run end to end; their prefill attention, decode MLP
and short conv go through the hand-written CUDA kernels on the card.
"""

from repro_torch.models.lm import (
    LM,
    init_lm,
    lm_decode_step,
    lm_logits,
    lm_prefill,
)
from repro_torch.models.weights import from_jax

__all__ = ["LM", "from_jax", "init_lm", "lm_decode_step", "lm_logits", "lm_prefill"]
