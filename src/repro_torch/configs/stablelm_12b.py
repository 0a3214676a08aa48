"""stablelm-12b: 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.

[hf:stabilityai/stablelm family; hf] — swiglu/silu decoder with RoPE + GQA.
"""
from .base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", n_layers=40, d_model=5120, d_ff=13824,
    vocab_size=100352,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=160),
    mlp_type="swiglu", activation="silu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="stablelm-12b-reduced", family="dense", n_layers=2, d_model=64, d_ff=160,
    vocab_size=512,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              q_chunk=32, kv_chunk=32),
    mlp_type="swiglu", activation="silu",
    param_dtype="float32", compute_dtype="float32",
)
