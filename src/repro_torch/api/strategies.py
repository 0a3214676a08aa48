"""Execution strategies: HOW a resolved workload runs (``repro.api.strategies``).

The training strategies (``nestpipe``, ``async``, ``serial``) each build a
:class:`~repro_torch.core.dbp.DBPDriver`; ``serve`` is read-only serving
and has no driver. New modes register here:

    register_strategy(DriverStrategy("my-mode", "nestpipe"))
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

from ..configs.base import NestPipeConfig
from ..core.dbp import DBPDriver
from ..core.store import build_store
from ..serve import FrozenStoreView


def build_workload_store(workload):
    """Build the store a resolved workload's config asks for."""
    return build_store(workload.npcfg.store, workload.engine,
                       n_micro=workload.n_micro)


@dataclass(frozen=True)
class DriverStrategy:
    """Strategy backed by the host DBPDriver; the paper's three modes are
    instances of it."""

    name: str
    driver_mode: str  # which step family DBPDriver runs (and whether it syncs)
    metrics_every: int = 8  # deferred metric-drain cadence (DBPDriver)

    def configure(self, npcfg: NestPipeConfig) -> NestPipeConfig:
        return npcfg

    def build_driver(self, fns, stream, workload, **driver_kw) -> DBPDriver:
        driver_kw.setdefault("clustering", workload.npcfg.clustering)
        driver_kw.setdefault("device_fields", list(workload.batch_shapes))
        driver_kw.setdefault("metrics_every", self.metrics_every)
        driver_kw.setdefault("lookahead", workload.npcfg.prefetch_ahead)
        if "store" not in driver_kw:
            driver_kw["store"] = build_workload_store(workload)
        return DBPDriver(fns, stream, workload.n_micro, mode=self.driver_mode,
                         **driver_kw)


@dataclass(frozen=True)
class InferenceStrategy:
    """Read-only serving: the DBP data path with the epilogue cut off.

    ``configure`` pins one micro-batch per window (a request window maps
    to exactly one lookup plan); there is no batch t+1 to overlap against,
    so nothing runs the dual-buffer sync.
    """

    name: str = "serve"

    def configure(self, npcfg: NestPipeConfig) -> NestPipeConfig:
        return dataclasses.replace(npcfg, fwp_microbatches=1)

    def build_driver(self, fns, stream, workload, **driver_kw):
        raise ValueError(
            "mode 'serve' is inference-only: there is no training driver; "
            "drive it through Session.serve_embeddings()")

    def build_view(self, workload, table) -> FrozenStoreView:
        """Build the workload's store tier, ingest the master table into it,
        and freeze it behind the read-only view."""
        store = build_workload_store(workload)
        store.ingest(table)
        return FrozenStoreView(store)


_STRATEGIES: Dict[str, object] = {}


def register_strategy(strategy):
    """Register an execution strategy under ``strategy.name``; a later
    registration replaces an earlier one."""
    _STRATEGIES[strategy.name] = strategy
    return strategy


def get_strategy(name: str):
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown execution mode {name!r}; registered: "
                       f"{sorted(_STRATEGIES)}") from None


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_STRATEGIES))


# The paper's three execution modes (§V baselines + NestPipe itself).
register_strategy(DriverStrategy("nestpipe", "nestpipe"))
register_strategy(DriverStrategy("async", "async"))
register_strategy(DriverStrategy("serial", "serial"))
register_strategy(InferenceStrategy())
