"""repro_torch.serve — embedding inference over frozen store views.

A read-only view over an ingested store (``view``), a window-coalescing
request batcher (``batcher``), the dispatch router with pluggable heads
(``router``), and zipf load generation with closed/open-loop drivers
(``loadgen``). Nothing here imports ``repro_torch.api``.
"""
from .batcher import CoalescedWindow, LatencyLog, ServeRequest, WindowBatcher
from .loadgen import run_closed_loop, run_open_loop, synthetic_requests
from .router import HEADS, ServeRouter, build_router
from .view import COMMIT_METRIC_KEYS, FrozenStoreView, ReadOnlyStoreError

__all__ = [
    "CoalescedWindow",
    "LatencyLog",
    "ServeRequest",
    "WindowBatcher",
    "run_closed_loop",
    "run_open_loop",
    "synthetic_requests",
    "HEADS",
    "ServeRouter",
    "build_router",
    "COMMIT_METRIC_KEYS",
    "FrozenStoreView",
    "ReadOnlyStoreError",
]
