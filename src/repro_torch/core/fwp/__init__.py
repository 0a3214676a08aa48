"""Frozen-window pipelining: key-centric clustering and the window executor."""
from .clustering import cluster_batch
from .executor import FwpStepOutputs, build_fwp_window, value_and_grad

__all__ = ["cluster_batch", "FwpStepOutputs", "build_fwp_window",
           "value_and_grad"]
