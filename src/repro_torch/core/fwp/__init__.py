"""Frozen-window pipelining helpers: key-centric clustering."""
from .clustering import cluster_batch

__all__ = ["cluster_batch"]
