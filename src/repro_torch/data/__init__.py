"""Synthetic data streams and the host input pipeline (numpy)."""
from .pipeline import PrefetchQueue, make_cluster_transform, stage_to_device
from .synthetic import RecsysBatch, SyntheticRecsysStream

__all__ = ["PrefetchQueue", "make_cluster_transform", "stage_to_device",
           "RecsysBatch", "SyntheticRecsysStream"]
