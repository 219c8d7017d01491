"""Architecture registry: ``get_config("gemma2-9b")`` and friends."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    applicable_shapes,
    long_context_capable,
    shape_by_name,
)

from repro_torch.configs import (  # noqa: E402
    gemma2_9b,
    gemma3_27b,
    gemma_2b,
    granite_moe_3b,
    llama4_maverick,
    mamba2_1_3b,
    phi3_mini_3_8b,
    qwen2_vl_2b,
    seamless_m4t_medium,
    zamba2_1_2b,
)

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen2_vl_2b, phi3_mini_3_8b, gemma2_9b, gemma_2b, gemma3_27b,
        granite_moe_3b, llama4_maverick, mamba2_1_3b, zamba2_1_2b,
        seamless_m4t_medium,
    )
}

ARCH_NAMES = tuple(sorted(_REGISTRY))


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}") from None


def reduced_config(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
                   vocab: int = 128, ff: int = 128) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps the structural features (GQA ratio, local/global pattern, MoE,
    SSM, hybrid sharing, enc-dec) while shrinking every dimension.
    """
    head_dim = 16
    n_heads = max(1, min(cfg.num_heads, 4)) if cfg.num_heads else 0
    n_kv = 0
    if cfg.num_heads:
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        n_kv = max(1, n_heads // ratio)
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(num_experts=min(cfg.moe.num_experts, 8),
                        top_k=min(cfg.moe.top_k, 2),
                        expert_ff=32,
                        shared_expert_ff=32 if cfg.moe.shared_expert_ff else 0,
                        every_n_layers=cfg.moe.every_n_layers)
    ssm = None
    if cfg.ssm is not None:
        ssm = SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                        chunk_size=16, ngroups=1)
    n_layers = layers
    if cfg.family == "hybrid":
        n_layers = max(layers, cfg.hybrid_attn_every)  # exercise the shared block
    if cfg.attn_pattern == "local_global_5_1":
        n_layers = 6
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=ff if cfg.d_ff else 0,
        vocab_size=vocab,
        window_size=8,
        mrope_sections=(2, 3, 3) if cfg.mrope else cfg.mrope_sections,
        moe=moe,
        ssm=ssm,
        hybrid_attn_every=min(cfg.hybrid_attn_every, 3) if cfg.hybrid_attn_every else 0,
        dtype="float32",
    )
