"""stablelm-3b: 32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b family; unverified] — swiglu/silu decoder
with RoPE; MHA (kv == q heads).
"""
from .base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560, d_ff=6912,
    vocab_size=50304,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=80),
    mlp_type="swiglu", activation="silu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="stablelm-3b-reduced", family="dense", n_layers=2, d_model=64, d_ff=160,
    vocab_size=512,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                              q_chunk=32, kv_chunk=32),
    mlp_type="swiglu", activation="silu",
    param_dtype="float32", compute_dtype="float32",
)
