"""gemma2-9b — dense. 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000,
local+global alternating (1:1), attention/final logit softcaps. [arXiv:2408.00118]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    mlp_variant="geglu",
    rope_theta=10000.0,
    attn_pattern="local_global_1_1",
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_pre_attn_scalar=224.0,   # d_model / num_heads
    tie_embeddings=True,
)
