"""Config dataclasses and the recsys arch registry."""
from .base import (
    NestPipeConfig,
    OptimizerConfig,
    RecsysModelConfig,
    SparseTableConfig,
)
from .registry import RECSYS_ARCHS, ArchSpec, get_arch

__all__ = ["NestPipeConfig", "OptimizerConfig", "RecsysModelConfig",
           "SparseTableConfig", "RECSYS_ARCHS", "ArchSpec", "get_arch"]
