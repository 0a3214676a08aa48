"""nemotron-4-340b: 96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.

[arXiv:2402.16819; unverified] — squared-ReLU non-gated MLP, GQA, RoPE.
Largest dense arch in the pool: bf16 params, full remat, FSDP over data.
"""
from .base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense", n_layers=96, d_model=18432,
    d_ff=73728, vocab_size=256000,
    attention=AttentionConfig(n_heads=96, n_kv_heads=8, head_dim=192),
    mlp_type="mlp", activation="relu2",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="nemotron-4-340b-reduced", family="dense", n_layers=2, d_model=96,
    d_ff=384, vocab_size=512,
    attention=AttentionConfig(n_heads=6, n_kv_heads=2, head_dim=16,
                              q_chunk=32, kv_chunk=32),
    mlp_type="mlp", activation="relu2",
    param_dtype="float32", compute_dtype="float32",
)
