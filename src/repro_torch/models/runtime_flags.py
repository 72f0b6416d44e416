"""Global implementation knobs, so that the baseline and the optimized
implementation run from the same model code (a before / after pair on
the same weights).

`Flags()`'s defaults are the everyday path, as the reference's are;
`set_baseline()` switches to the plain implementations the reference's
baselines were recorded with, `set_optimized()` to its tuned
configuration (which is not `Flags()`: it sets `ssm_chunk_override` to
128).  `overrides(**kw)` sets fields for a `with` block and restores
them after; an unknown name raises `AttributeError`.  `FLAGS` is one
object per process: code that sets a field for a while restores it.

Fields the port reads:

- `attention_impl`: "flash" runs full-sequence attention through the
  flash kernel, decode through `chunked_attention`'s one-shot pass;
  "chunked" runs both through its online-softmax loop over 512-key
  chunks (`models.attention`).
- `mla_absorb`: MLA's decode in the latent space (True) or with the
  latents expanded to per-head k / v over the whole cache (False).
- `ssm_chunk_override`, `ssm_chunk_remat`: mamba2's SSD chunk length
  (0 keeps the config's), and, under grad, one checkpoint per chunk
  step inside the per-super-block one (`models.mamba`).
- `attention_cp_axis`: a non-empty axis sends full-sequence attention to
  `chunked_attention`; under a device mesh in effect
  (`distributed.sharding.use_mesh`) whose axis of that name is larger
  than 1, q's sequence stripes run on that axis's cards
  (`attention.cp_attention`), else the call runs whole on q's card.
- `fsdp_min_tree_bytes`: the sharding builders' FSDP threshold; 0
  shards every tree (`distributed.sharding`).

Fields of the reference's `Flags` that are deliberately absent, so that
setting one raises `AttributeError` as any unknown name does:

- `flash_q_blk`, `flash_kv_blk`: the block sizes of the reference's XLA
  flash scan; the CUDA kernel has tiles of its own, fixed per head dim.
- `flash_p_dtype`: the flash kernel casts P to v's dtype, as the
  reference's Pallas kernel does; under the baseline attention never
  reaches flash.
- `moe_shardmap`: reserved in the reference, and read nowhere there.
"""

from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass(slots=True)
class Flags:
    attention_impl: str = "flash"  # "flash" | "chunked"
    mla_absorb: bool = True  # latent-space decode scoring (no k/v expand)
    # SSD (mamba2): remat each chunk step (backward recomputes the dual-form
    # intermediates instead of storing them); 0 = use cfg.ssm.chunk
    ssm_chunk_remat: bool = True
    ssm_chunk_override: int = 0
    # context-parallel attention: shard the q sequence dim over this mesh
    # axis inside attention (prefill of archs whose head counts do not
    # divide the model axis)
    attention_cp_axis: str = ""
    # adaptive FSDP: replicate param trees smaller than this (bytes); larger
    # trees shard over (pod, data)
    fsdp_min_tree_bytes: int = 3 << 30


FLAGS = Flags()


def set_baseline() -> None:
    FLAGS.attention_impl = "chunked"
    FLAGS.mla_absorb = False
    FLAGS.ssm_chunk_remat = False
    FLAGS.ssm_chunk_override = 0
    FLAGS.attention_cp_axis = ""
    FLAGS.fsdp_min_tree_bytes = 0  # baseline: FSDP everything


def set_optimized() -> None:
    FLAGS.attention_impl = "flash"
    FLAGS.mla_absorb = True
    FLAGS.ssm_chunk_remat = True
    FLAGS.ssm_chunk_override = 128
    FLAGS.fsdp_min_tree_bytes = 3 << 30


@contextlib.contextmanager
def overrides(**kw):
    old = {k: getattr(FLAGS, k) for k in kw}
    try:
        for k, v in kw.items():
            setattr(FLAGS, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(FLAGS, k, v)


@contextlib.contextmanager
def restored():
    """Every field as it was on entry, restored on exit, whatever the block
    set (by `set_baseline`, `set_optimized` or by hand)."""
    old = dataclasses.asdict(FLAGS)
    try:
        yield FLAGS
    finally:
        for k, v in old.items():
            setattr(FLAGS, k, v)
