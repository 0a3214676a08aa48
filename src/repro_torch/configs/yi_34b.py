"""yi-34b: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

[arXiv:2403.04652; hf] — llama-architecture GQA decoder (swiglu/silu, RoPE).
"""
from .base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168, d_ff=20480,
    vocab_size=64000,
    attention=AttentionConfig(n_heads=56, n_kv_heads=8, head_dim=128,
                              rope_theta=5000000.0),
    mlp_type="swiglu", activation="silu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="yi-34b-reduced", family="dense", n_layers=2, d_model=64, d_ff=160,
    vocab_size=512,
    attention=AttentionConfig(n_heads=8, n_kv_heads=2, head_dim=8,
                              q_chunk=32, kv_chunk=32),
    mlp_type="swiglu", activation="silu",
    param_dtype="float32", compute_dtype="float32",
)
