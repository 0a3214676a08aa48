"""Config dataclasses and the arch registry (dense LM and recsys)."""
from .base import (
    AttentionConfig,
    ModelConfig,
    NestPipeConfig,
    OptimizerConfig,
    RecsysModelConfig,
    SparseTableConfig,
)
from .registry import LM_ARCHS, RECSYS_ARCHS, ArchSpec, get_arch

__all__ = ["AttentionConfig", "ModelConfig", "NestPipeConfig", "OptimizerConfig",
           "RecsysModelConfig", "SparseTableConfig", "LM_ARCHS", "RECSYS_ARCHS", "ArchSpec", "get_arch"]
