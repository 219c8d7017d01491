"""seamless-m4t-medium — audio enc-dec. 12L encoder + 12L decoder,
d_model=1024 16H d_ff=4096 vocab=256206. [arXiv:2308.11596]

The audio frontend (fbank/conformer feature extractor) is a STUB:
``input_specs`` provides precomputed frame embeddings for the encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,                 # decoder layers
    num_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    mlp_variant="swiglu",
    rope_theta=10000.0,
    attn_pattern="global",
    tie_embeddings=True,
    embedding_inputs=True,
)
