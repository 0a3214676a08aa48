"""DeviceStore: the master table in device memory, the trivial fetch plan.

Routing and retrieval are the engine's ops, called directly (step
functions come with training). ``plan`` never touches the host
(``host_keys is None``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..embedding.engine import DualBuffer, EmbeddingEngine
from ..embedding.table import EmbeddingTableState
from .base import FetchPlan, StageTimers, placeholder_table


class DeviceStore:
    """Device-resident master behind the store surface."""

    tier = "device"
    # no host-side sparse exchange to compress
    sparse_comm = "off"

    def __init__(self, engine: EmbeddingEngine, *, n_micro: int = 1):
        self.engine = engine
        self.n_micro = n_micro
        self.table: Optional[EmbeddingTableState] = None
        self.owns_master = False
        self.stage_timers = StageTimers()

    # -- lifecycle -------------------------------------------------------

    def ingest(self, table: EmbeddingTableState) -> EmbeddingTableState:
        self.table = table
        self.owns_master = True
        return placeholder_table(table)

    def export_table(self) -> EmbeddingTableState:
        """Non-destructive view (the live device table)."""
        assert self.table is not None, "export before ingest"
        return self.table

    def release(self) -> EmbeddingTableState:
        table, self.table, self.owns_master = self.table, None, False
        assert table is not None, "release before ingest"
        return table

    # -- DBP stages ------------------------------------------------------

    def route(self, keys):
        """Stage-3 routing of an (N, *batch) key window (numpy or tensor)."""
        with self.stage_timers.timed("plan_ms"):
            keys = torch.as_tensor(keys, dtype=torch.int32,
                                   device=self.engine.device)
            return self.engine.route_window(keys, self.n_micro)

    def plan_from_window(self, window) -> FetchPlan:
        return FetchPlan(window, None)

    def plan(self, keys) -> FetchPlan:
        return self.plan_from_window(self.route(keys))

    def retrieve(self, plan: FetchPlan) -> DualBuffer:
        with self.stage_timers.timed("retrieve_ms"):
            return self.engine.retrieve(self.table, plan.window)

    # -- metrics ---------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        return dict(self.stage_timers.as_dict())
