"""Embedding storage: where the master rows live, behind one read surface.

``plan(keys)``        DBP stage 3: route a window (and, for the host
                      tiers, pull the owner-side union key list to the host).
``retrieve(plan)``    DBP stage 4a: master rows -> a fresh
                      :class:`~repro_torch.core.embedding.engine.DualBuffer`.
``commit(buffer, plan)``  DBP stage 5'': write the updated buffer back
                      into the master.

Tiers
-----
``DeviceStore``  the master in device memory; retrieval and write-back are
                 the engine's ops.
``HostStore``    the master in (pinned) host memory; retrieval gathers on
                 the host and copies only the compact buffer to the card,
                 the commit copies it back and scatters into the master.
``CachedStore``  ``HostStore`` plus a chunked device cache of hot rows:
                 hits are served on the card through the gather kernel,
                 only misses cross the bus, evictions write back to the
                 host master.

The consistency argument lives in the buffer domain, so the tier never
changes a value: training replays bit for bit through all three.

Selection: ``NestPipeConfig.store`` (``"auto"`` resolves ``$REPRO_STORE``,
then ``"device"``). The async stage executor (``async_exec.py``) runs the
host-side stages of any tier on worker threads. The mesh-sharded tier is
not ported (``ROADMAP.md``, port Queue 1, item 6).
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..embedding.engine import DualBuffer, WindowPlan
from ..embedding.table import EmbeddingTableState

STORES = ("device", "host", "cached")

# Per-stage wall-time counter keys every tier reports through ``metrics()``.
# On the device tier they measure the host time to enqueue each stage: the
# device work is asynchronous.
STAGE_TIMER_KEYS = ("plan_ms", "retrieve_ms", "commit_ms", "h2d_ms")


class StageTimers:
    """Cumulative per-stage wall-time counters (milliseconds), thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ms = {k: 0.0 for k in STAGE_TIMER_KEYS}

    def add(self, key: str, seconds: float) -> None:
        with self._lock:
            self._ms[key] += seconds * 1e3

    @contextmanager
    def timed(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(key, time.perf_counter() - t0)

    def as_dict(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._ms)


class FetchPlan(NamedTuple):
    """One batch's routing artifacts, as a store needs them. ``host_keys``
    is ``None`` on the device tier, which never needs keys on the host."""

    window: WindowPlan
    host_keys: Optional[np.ndarray]


@runtime_checkable
class EmbeddingStore(Protocol):
    """What every tier offers the DBP driver and the serving view.

    Lifecycle: the driver ``ingest``s the master out of the train state at
    the start of a run (the state keeps a zero-row placeholder), calls
    ``plan`` / ``retrieve`` / ``commit`` per step, may ``export_table`` (a
    snapshot) and ``release``s the master back at the end.
    ``plan == plan_from_window(route(keys))``: routing is device work, the
    second half pulls what a host tier needs to the host, after the CUDA
    event ``after`` when one is given (the async executor records it on
    the driver thread after the routing).
    """

    tier: str
    owns_master: bool
    sparse_comm: str

    def ingest(self, table: EmbeddingTableState) -> EmbeddingTableState: ...

    def route(self, keys) -> WindowPlan: ...

    def plan_from_window(self, window: WindowPlan, after=None) -> "FetchPlan": ...

    def plan(self, keys) -> "FetchPlan": ...

    def retrieve(self, plan: "FetchPlan") -> DualBuffer: ...

    def commit(self, buffer: DualBuffer, plan: Optional["FetchPlan"] = None) -> None: ...

    def export_table(self) -> EmbeddingTableState: ...

    def release(self) -> EmbeddingTableState: ...

    def metrics(self) -> Dict[str, float]: ...


def placeholder_table(table: EmbeddingTableState) -> EmbeddingTableState:
    """Zero-row stand-in for the master while a store owns it."""
    d = table.rows.shape[-1]
    dev = table.rows.device
    return EmbeddingTableState(
        rows=torch.zeros((0, d), dtype=table.rows.dtype, device=dev),
        accum=torch.zeros((0,), dtype=torch.float32, device=dev),
    )


def resolve_store(store: Optional[str] = None) -> str:
    """Resolve a store tier name: explicit arg > $REPRO_STORE > "device"
    (``"auto"`` and None fall through)."""
    for cand in (store, os.environ.get("REPRO_STORE")):
        if cand and cand != "auto":
            if cand not in STORES:
                raise ValueError(
                    f"unknown embedding store {cand!r}; expected one of "
                    f"{STORES} or 'auto'")
            return cand
    return "device"


def build_store(
    name: Optional[str],
    engine,
    *,
    n_micro: int = 1,
    cache_rows: int = 0,
    cache_admit: int = 1,
    cache_chunk_rows: int = 8,
    cache_policy: Optional[str] = None,
    prefetch_ahead: int = 1,
    sparse_comm: Optional[str] = None,
):
    """Construct the store for a tier name (see :func:`resolve_store`) over
    ``engine``, whose device the buffers live on.

    ``cache_policy`` and ``sparse_comm`` are validated on every tier and
    acted on where a host path exists. ``prefetch_ahead`` sizes the cached
    tier's rolling horizon (the oracle policy's window) to the prefetcher's
    depth: ``prefetch_ahead + 1`` windows."""
    from .cached import CachedStore
    from .comm import SparseComm, resolve_sparse_comm
    from .device import DeviceStore
    from .host import HostStore
    from .policy import resolve_cache_policy

    tier = resolve_store(name)
    resolve_cache_policy(cache_policy)  # validate even where it is a no-op
    if tier == "device":
        resolve_sparse_comm(sparse_comm)  # validate even where it is a no-op
        return DeviceStore(engine, n_micro=n_micro)
    comm = SparseComm(sparse_comm)
    if tier == "host":
        return HostStore(engine, n_micro=n_micro, comm=comm)
    return CachedStore(
        engine, n_micro=n_micro, comm=comm, capacity=cache_rows,
        admit_threshold=cache_admit, chunk_rows=cache_chunk_rows,
        policy=cache_policy, horizon_windows=prefetch_ahead + 1)
