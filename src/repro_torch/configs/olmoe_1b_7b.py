"""olmoe-1b-7b: 16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert),
MoE 64 experts top-8, vocab=50304.

[arXiv:2409.02060; hf] — fine-grained MoE through the capacity-slotted
dispatch (``models.layers.apply_moe_slotted``).
"""
from .base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048, d_ff=1024,
    vocab_size=50304,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=8, capacity_factor=1.25),
    mlp_type="swiglu", activation="silu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="olmoe-1b-7b-reduced", family="moe", n_layers=2, d_model=64, d_ff=32,
    vocab_size=512,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                              q_chunk=32, kv_chunk=32),
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=2.0),
    mlp_type="swiglu", activation="silu",
    param_dtype="float32", compute_dtype="float32",
)
