"""Architecture configuration of the language models and the dry run's
shape cells (a copy of the reference's `configs/base.py`).

Every architecture is a frozen `ArchConfig`; `register` maps --arch ids to
configs.  Reduced (smoke) variants are derived with `.reduced()` -- same
family/structure, tiny dims.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0  # shared (always-on) experts
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None  # window length for local layers
    local_global_period: Optional[int] = None  # e.g. 6 => 5 local : 1 global
    # substructure
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_period: Optional[int] = None  # zamba2: shared block every p
    shared_attn_lora_rank: int = 0
    # encoder-decoder (seamless)
    encoder_layers: int = 0
    # extras
    mtp: bool = False  # deepseek-v3 multi-token-prediction head
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # activation/param dtype for full-scale runs
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic memory path exists (SSM / hybrid / sliding window)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.local_global_period is not None
        )

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        small_moe = (
            dataclasses.replace(self.moe, n_experts=min(8, self.moe.n_experts))
            if self.moe
            else None
        )
        small_mla = (
            dataclasses.replace(
                self.mla, q_lora_rank=32, kv_lora_rank=16,
                qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8,
            )
            if self.mla
            else None
        )
        small_ssm = (
            dataclasses.replace(self.ssm, d_state=16, head_dim=8, chunk=16)
            if self.ssm
            else None
        )
        if self.shared_attn_period:
            n_layers = 5  # at least one shared-attn insertion (period -> 2)
        elif self.local_global_period:
            n_layers = self.local_global_period + 2  # one full period + tail
        else:
            n_layers = min(4, self.n_layers)
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=96 if not self.moe else 32,
            head_dim=16,
            vocab_size=256,
            sliding_window=16 if self.sliding_window else None,
            local_global_period=self.local_global_period,
            moe=small_moe,
            mla=small_mla,
            ssm=small_ssm,
            shared_attn_period=2 if self.shared_attn_period else None,
            shared_attn_lora_rank=4 if self.shared_attn_lora_rank else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # import the config modules lazily so registration happens
        import repro_torch.configs.archs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> Tuple[str, ...]:
    import repro_torch.configs.archs  # noqa: F401

    return tuple(sorted(_REGISTRY))


def cell_is_defined(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell; else the skip reason."""
    if shape.name == "long_500k" and not arch.supports_long_context:
        return False, "pure full-attention arch: 512k dense KV cache excluded by design (DESIGN.md S5)"
    return True, ""
