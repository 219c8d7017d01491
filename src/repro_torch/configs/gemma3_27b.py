"""gemma3-27b — dense. 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global, 128k context. [hf:google/gemma-3]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    mlp_variant="geglu",
    rope_theta=1000000.0,
    attn_pattern="local_global_5_1",
    window_size=1024,
    query_pre_attn_scalar=168.0,
    tie_embeddings=True,
)
