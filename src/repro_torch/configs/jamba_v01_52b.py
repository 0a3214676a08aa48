"""jamba-v0.1-52b: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16 experts top-2, Mamba:attention 1:7 interleave.

[arXiv:2403.19887; hf] — period-8 blocks: attention at offset 4, Mamba
elsewhere; MoE FFN every other layer (odd offsets). A cache holds k and v
at an attention position and the conv and ssm states at a Mamba one.
"""
from .base import AttentionConfig, MambaConfig, ModelConfig, MoEConfig

_PATTERN = tuple(
    ("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    d_ff=14336, vocab_size=65536,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128),
    mamba=MambaConfig(d_state=16, headdim=64, expand=2, n_groups=1, d_conv=4,
                      chunk_size=256),
    moe=MoEConfig(num_experts=16, top_k=2, capacity_factor=1.25),
    layer_pattern=_PATTERN,
    mlp_type="swiglu", activation="silu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
    subquadratic=True,
)

_RPATTERN = tuple(
    ("attn" if i == 1 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(4)
)

REDUCED = ModelConfig(
    name="jamba-v0.1-52b-reduced", family="hybrid", n_layers=4, d_model=64,
    d_ff=96, vocab_size=512,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              q_chunk=32, kv_chunk=32),
    mamba=MambaConfig(d_state=8, headdim=8, expand=2, n_groups=1, d_conv=4,
                      chunk_size=16),
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0),
    layer_pattern=_RPATTERN,
    mlp_type="swiglu", activation="silu",
    param_dtype="float32", compute_dtype="float32",
    subquadratic=True,
)
