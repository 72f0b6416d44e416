"""The ten registered architectures (a copy of the reference's
`configs/archs.py`: the configs are data).

Sources in each config's `notes`; deepseek-v3 uses uniform MoE layers at
d_ff=2048.  The port serves gemma3-1b and mamba2-1.3b so far.
"""

from __future__ import annotations

from repro_torch.configs.base import (
    ArchConfig,
    MLAConfig,
    MoEConfig,
    SSMConfig,
    register,
)


@register("chameleon-34b")
def chameleon_34b() -> ArchConfig:
    # [vlm] early-fusion; VQ image tokens share the 65536 vocab; frontend
    # stubbed (tokens arrive pre-quantised).  qk-norm per Chameleon.
    return ArchConfig(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab_size=65536, qk_norm=True,
        notes="arXiv:2405.09818; early fusion, VQ image tokens",
    )


@register("mamba2-1.3b")
def mamba2_1_3b() -> ArchConfig:
    # [ssm] attention-free SSD; d_ff=0 (no MLP blocks).
    return ArchConfig(
        name="mamba2-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
        tie_embeddings=True,
        notes="arXiv:2405.21060; SSD (state-space duality)",
    )


@register("moonshot-v1-16b-a3b")
def moonshot_v1_16b_a3b() -> ArchConfig:
    # [moe] 64 routed experts, top-6, per-expert d_ff=1408.
    return ArchConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=163840,
        moe=MoEConfig(n_experts=64, top_k=6),
        notes="hf:moonshotai/Moonlight-16B-A3B; kimi/moonlight 64e top-6",
    )


@register("deepseek-v3-671b")
def deepseek_v3_671b() -> ArchConfig:
    # [moe] MLA + 1 shared + 256 routed top-8 + MTP.  Sheet gives d_ff=2048
    # uniformly (the HF model's 3 dense first layers are not modelled).
    return ArchConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=2048, vocab_size=129280,
        moe=MoEConfig(n_experts=256, top_k=8, n_shared=1),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        mtp=True,
        notes="arXiv:2412.19437; MLA, 1 shared + 256 routed top-8, MTP",
    )


@register("seamless-m4t-medium")
def seamless_m4t_medium() -> ArchConfig:
    # [audio] encoder-decoder; speech frontend stubbed to frame embeddings.
    return ArchConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=256206,
        encoder_layers=12,
        notes="arXiv:2308.11596; enc-dec, multimodal (frontend stub)",
    )


@register("deepseek-67b")
def deepseek_67b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-67b", family="dense",
        n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab_size=102400,
        notes="arXiv:2401.02954; llama-arch",
    )


@register("stablelm-3b")
def stablelm_3b() -> ArchConfig:
    return ArchConfig(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab_size=50304,
        notes="hf:stabilityai/stablelm-2-1_6b family",
    )


@register("gemma3-1b")
def gemma3_1b() -> ArchConfig:
    # 5 local : 1 global, 512-token sliding window, head_dim 256.
    return ArchConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
        d_ff=6912, vocab_size=262144, head_dim=256,
        sliding_window=512, local_global_period=6,
        tie_embeddings=True,
        notes="hf:google/gemma-3-1b-pt; 5:1 local:global, 128k context",
    )


@register("qwen2.5-14b")
def qwen2_5_14b() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-14b", family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab_size=152064, qkv_bias=True,
        notes="hf:Qwen/Qwen2.5 family; GQA, QKV bias",
    )


@register("zamba2-7b")
def zamba2_7b() -> ArchConfig:
    # [hybrid] 81 Mamba2 blocks + shared attention block every 6, with
    # per-invocation LoRA (Zamba2 design).
    return ArchConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
        shared_attn_period=6, shared_attn_lora_rank=128,
        notes="arXiv:2411.15242; Mamba2 + shared attn blocks",
    )
