"""granite-moe-3b-a800m — MoE. 32L d_model=1536 24H (GQA kv=8) expert d_ff=512
vocab=49155, 40 experts top-8. [hf:ibm-granite/granite-3.0]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                       # per-expert ff
    vocab_size=49155,
    head_dim=64,
    mlp_variant="swiglu",
    rope_theta=10000.0,
    attn_pattern="global",
    tie_embeddings=True,
    moe=MoEConfig(num_experts=40, top_k=8, expert_ff=512, every_n_layers=1),
)
