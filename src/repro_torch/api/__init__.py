"""``repro_torch.api`` — the front door to the PyTorch/CUDA port.

    from repro_torch.api import Session

    rep = Session.from_arch("dlrm-ctr").serve_embeddings(head="dlrm")
"""
from .session import EmbedServeReport, Session
from .strategies import InferenceStrategy, build_workload_store

__all__ = ["Session", "EmbedServeReport", "InferenceStrategy",
           "build_workload_store"]
