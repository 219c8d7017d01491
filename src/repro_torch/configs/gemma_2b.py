"""gemma-2b — dense. 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256. [arXiv:2403.08295]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    mlp_variant="geglu",
    rope_theta=10000.0,
    attn_pattern="global",
    tie_embeddings=True,
)
