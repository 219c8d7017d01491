"""qwen2-vl-2b — VLM backbone. 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE, dynamic resolution. [arXiv:2409.12191]

The vision frontend is a STUB: ``input_specs`` provides precomputed patch
embeddings plus M-RoPE (t,h,w) position ids; only the LM backbone is built.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    mlp_variant="swiglu",
    rope_theta=1000000.0,
    mrope=True,
    mrope_sections=(16, 24, 24),
    attn_pattern="global",
    tie_embeddings=True,
    embedding_inputs=True,
)
