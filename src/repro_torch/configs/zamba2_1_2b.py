"""zamba2-1.2b — hybrid. 38L d_model=2048, Mamba2 backbone (d_state=64) with a
single SHARED attention+MLP block (32H, d_ff=8192) applied every 6 mamba
layers. vocab=32000. [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    mlp_variant="geglu",
    attn_pattern="global",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, ngroups=1),
    hybrid_attn_every=6,
)
