"""grok-1-314b: 64L d_model=6144 48H (GQA kv=8) d_ff=32768, MoE 8e top-2,
vocab=131072.

[hf:xai-org/grok-1; unverified] — 316.5 B params: the port holds it
against JAX at its reduced size only.
"""
from .base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144, d_ff=32768,
    vocab_size=131072,
    attention=AttentionConfig(n_heads=48, n_kv_heads=8, head_dim=128),
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    mlp_type="swiglu", activation="silu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="grok-1-314b-reduced", family="moe", n_layers=2, d_model=64, d_ff=96,
    vocab_size=512,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              q_chunk=32, kv_chunk=32),
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0),
    mlp_type="swiglu", activation="silu",
    param_dtype="float32", compute_dtype="float32",
)
