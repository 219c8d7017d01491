"""mamba2-1.3b — SSM (attention-free). 48L d_model=2048 vocab=50280,
SSD (state-space duality), d_state=128, headdim=64, expand=2. [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn_pattern="global",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, ngroups=1),
)
