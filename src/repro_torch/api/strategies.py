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


def build_workload_store(workload, *, serial: bool = False):
    """Build the store a resolved workload's config asks for: one seam for
    the training drivers and the serving replicas, so a replica gets the
    tier its training run would use.

    The serial baseline is device-resident by definition: an explicit
    non-device store in the config raises, while ``$REPRO_STORE`` (a blunt
    override for whole-suite sweeps) falls back to the device tier."""
    npcfg = workload.npcfg
    name = npcfg.store
    if serial:
        if name not in ("auto", "device"):
            raise ValueError(
                f"mode 'serial' is the device-resident baseline; "
                f"store={name!r} needs a pipelined mode (nestpipe | async)")
        name = "device"
    return build_store(
        name, workload.engine, n_micro=workload.n_micro,
        cache_rows=npcfg.cache_rows, cache_admit=npcfg.cache_admit,
        cache_chunk_rows=npcfg.cache_chunk_rows,
        cache_policy=npcfg.cache_policy,
        prefetch_ahead=npcfg.prefetch_ahead,
        sparse_comm=npcfg.sparse_comm)


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
        driver_kw.setdefault("async_stages", workload.npcfg.async_stages)
        driver_kw.setdefault("stage_workers", workload.npcfg.stage_workers)
        if "store" not in driver_kw:
            driver_kw["store"] = build_workload_store(
                workload, serial=self.driver_mode == "serial")
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
