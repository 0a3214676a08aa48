"""pixtral-12b: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

[hf:mistralai/Pixtral-12B-2409; unverified] — a mistral-nemo-style decoder
backbone through the decoder-only stack (``models.transformer``); the
pixtral-ViT vision frontend is a stub (``models.frontend``: precomputed
patch embeddings, 256 patches prepended to the text sequence, zeros in the
training stream). NestPipe's embedding engine serves the text tokens'
lookups.
"""
from .base import AttentionConfig, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120, d_ff=14336,
    vocab_size=131072,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=160,
                              rope_theta=1000000.0),
    frontend=FrontendConfig(kind="vision", n_positions=256),
    mlp_type="swiglu", activation="silu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="pixtral-12b-reduced", family="vlm", n_layers=2, d_model=64, d_ff=160,
    vocab_size=512,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              q_chunk=32, kv_chunk=32),
    frontend=FrontendConfig(kind="vision", n_positions=8),
    mlp_type="swiglu", activation="silu",
    param_dtype="float32", compute_dtype="float32",
)
