"""Synthetic data streams (numpy)."""
from .synthetic import RecsysBatch, SyntheticRecsysStream

__all__ = ["RecsysBatch", "SyntheticRecsysStream"]
