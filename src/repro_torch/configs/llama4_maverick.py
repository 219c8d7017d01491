"""llama4-maverick-400b-a17b — MoE. 48L d_model=5120 40H (GQA kv=8)
vocab=202048, MoE 128 experts top-1 (+ shared expert), early fusion.
[hf:meta-llama/Llama-4]

Interpretation note (DESIGN.md §4): routed experts use d_ff=8192 (as
assigned) and MoE layers interleave with dense layers (every 2nd layer,
dense d_ff=16384) plus one always-on shared expert per MoE layer — this is
the published Maverick layout and is required to land at ~400B total /
~17B active parameters.  Optimizer moments are kept in bf16 so the
train_4k cell fits 16 GB/chip HBM at 256 chips (ZeRO-3 over data axis).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=16384,                    # dense interleave layers
    vocab_size=202048,
    head_dim=128,
    mlp_variant="swiglu",
    rope_theta=500000.0,
    attn_pattern="global",
    tie_embeddings=True,
    moe=MoEConfig(num_experts=128, top_k=1, expert_ff=8192,
                  shared_expert_ff=8192, every_n_layers=2),
    optimizer_state_dtype="bfloat16",
)
