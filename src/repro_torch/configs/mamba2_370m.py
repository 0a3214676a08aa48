"""mamba2-370m: 48L d_model=1024, attention-free SSD, ssm_state=128.

[arXiv:2405.21060; unverified] — pure Mamba2 stack (no MLP blocks),
headdim=64, expand=2, n_groups=1, through ``models.mamba`` (the chunked
SSD). NestPipe's embedding engine serves its vocabulary lookups.
"""
from .base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024, d_ff=0,
    vocab_size=50288,  # 50280 padded to %16==0 for vocab-parallel head
    mamba=MambaConfig(d_state=128, headdim=64, expand=2, n_groups=1, d_conv=4,
                      chunk_size=256),
    layer_pattern=(("mamba", "none"),),
    param_dtype="float32", compute_dtype="bfloat16",
    subquadratic=True,
)

REDUCED = ModelConfig(
    name="mamba2-370m-reduced", family="ssm", n_layers=2, d_model=64, d_ff=0,
    vocab_size=512,
    mamba=MambaConfig(d_state=16, headdim=8, expand=2, n_groups=1, d_conv=4,
                      chunk_size=16),
    layer_pattern=(("mamba", "none"),),
    param_dtype="float32", compute_dtype="float32",
    subquadratic=True,
)
