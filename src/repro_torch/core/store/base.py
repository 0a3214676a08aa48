"""Embedding storage: where the master rows live, behind one read surface.

``plan(keys)``        DBP stage 3: route a window.
``retrieve(plan)``    DBP stage 4a: master rows -> a fresh
                      :class:`~repro_torch.core.embedding.engine.DualBuffer`.

Only the device tier (master in device memory) is ported; the host and
cached tiers come later (``ROADMAP.md``, port Queue 1) and raise here.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..embedding.engine import WindowPlan
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


def placeholder_table(table: EmbeddingTableState) -> EmbeddingTableState:
    """Zero-row stand-in for the master while a store owns it."""
    d = table.rows.shape[-1]
    dev = table.rows.device
    return EmbeddingTableState(
        rows=torch.zeros((0, d), dtype=table.rows.dtype, device=dev),
        accum=torch.zeros((0,), dtype=torch.float32, device=dev),
    )


def resolve_store(store: Optional[str] = None) -> str:
    """Resolve a store tier name; ``"auto"``/None -> ``"device"``."""
    if store in (None, "auto"):
        return "device"
    if store not in STORES:
        raise ValueError(f"unknown embedding store {store!r}; expected one "
                         f"of {STORES} or 'auto'")
    return store


def build_store(name: Optional[str], engine, *, n_micro: int = 1):
    """Construct the store for a tier name (see :func:`resolve_store`)."""
    from .device import DeviceStore

    tier = resolve_store(name)
    if tier != "device":
        raise NotImplementedError(
            f"store={tier!r} is not ported yet: the host and cached tiers "
            "are ROADMAP.md port Queue 1, 'Host + cached tiers'")
    return DeviceStore(engine, n_micro=n_micro)
