"""``repro_torch.api`` — the front door to the PyTorch/CUDA port.

    from repro_torch.api import Session

    sess = Session.from_arch("dlrm-ctr", mode="nestpipe", global_batch=8192)
    print(sess.train(8).summary)
    rep = sess.serve_embeddings(head="dlrm")
    print(Session.from_arch("stablelm-12b").serve(batch=8, prompt_len=2048,
                                                  gen=32).summary)
"""
from .session import EmbedServeReport, ServeReport, Session, TrainReport
from .strategies import (
    DriverStrategy,
    InferenceStrategy,
    available_strategies,
    build_workload_store,
    get_strategy,
    register_strategy,
)
from .streams import resolve_stream

__all__ = ["Session", "EmbedServeReport", "ServeReport", "TrainReport", "DriverStrategy",
           "InferenceStrategy", "available_strategies", "build_workload_store",
           "get_strategy", "register_strategy", "resolve_stream"]
