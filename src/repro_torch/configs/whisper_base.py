"""whisper-base: 6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865.

[arXiv:2212.04356; unverified] — enc-dec through ``models.encdec``: the
conv audio frontend is a stub (precomputed frame embeddings, n_frames=1500,
drawn by the stream), a bidirectional encoder and a causal decoder with
cross attention. LayerNorm + GELU + non-gated MLP per the whisper
architecture; RoPE on the self-attention of both stacks, as in the JAX
package. NestPipe's embedding engine serves the decoder's token lookups.
"""
from .base import AttentionConfig, EncoderConfig, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512, d_ff=2048,
    vocab_size=51872,  # 51865 padded to %16==0 for vocab-parallel head
    attention=AttentionConfig(n_heads=8, n_kv_heads=8, head_dim=64),
    encoder=EncoderConfig(n_layers=6, n_frames=1500),
    frontend=FrontendConfig(kind="audio", n_positions=1500),
    mlp_type="mlp", activation="gelu", norm_type="layernorm",
    param_dtype="float32", compute_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="whisper-base-reduced", family="audio", n_layers=2, d_model=64,
    d_ff=128, vocab_size=512,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                              q_chunk=32, kv_chunk=32),
    encoder=EncoderConfig(n_layers=2, n_frames=24),
    frontend=FrontendConfig(kind="audio", n_positions=24),
    mlp_type="mlp", activation="gelu", norm_type="layernorm",
    param_dtype="float32", compute_dtype="float32",
)
