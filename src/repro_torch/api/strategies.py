"""Execution strategies, serving subset: how a resolved workload runs.

Only read-only serving is ported; the training strategies (serial, async,
nestpipe) come with the training slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..configs.base import NestPipeConfig
from ..core.store import build_store
from ..serve import FrozenStoreView


def build_workload_store(workload):
    """Build the store a resolved workload's config asks for."""
    return build_store(workload.npcfg.store, workload.engine,
                       n_micro=workload.n_micro)


@dataclass(frozen=True)
class InferenceStrategy:
    """Read-only serving: the DBP data path with the epilogue cut off.

    ``configure`` pins one micro-batch per window: a request window maps to
    exactly one lookup plan. (There is no dual-buffer pipelining to turn
    off: nothing is ported that would pipeline.)
    """

    name: str = "serve"

    def configure(self, npcfg: NestPipeConfig) -> NestPipeConfig:
        return dataclasses.replace(npcfg, fwp_microbatches=1)

    def build_view(self, workload, table) -> FrozenStoreView:
        """Build the workload's store tier, ingest the master table into it,
        and freeze it behind the read-only view."""
        store = build_workload_store(workload)
        store.ingest(table)
        return FrozenStoreView(store)
