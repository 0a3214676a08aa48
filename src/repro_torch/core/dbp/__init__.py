"""Dual-buffer pipelining: the host driver over a store."""
from .pipeline import MODES, DBPDriver, PipelineStats

__all__ = ["MODES", "DBPDriver", "PipelineStats"]
