"""FrozenStoreView: a read-only view over an ingested store.

Serving is the training data path minus the epilogue: requests are routed
(DBP stage 3), rows are retrieved into a buffer (stage 4a), and the FWP
lookup serves embeddings out of that buffer, but nothing is ever written
back. ``plan`` / ``route`` / ``plan_from_window`` / ``retrieve`` delegate
to the wrapped tier unchanged; every mutation path raises
:class:`ReadOnlyStoreError`; ``metrics`` drops the commit-stage fields a
read path structurally lacks. ``set_read_horizon`` forwards the request
queue's visible keys to a cached tier's admission.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..core.embedding.engine import DualBuffer
from ..core.store.base import FetchPlan

# Commit-stage metric fields that have no read-path meaning.
COMMIT_METRIC_KEYS = ("commit_ms", "commits")


class ReadOnlyStoreError(RuntimeError):
    """A mutation was attempted through a FrozenStoreView."""


class FrozenStoreView:
    """Read-only facade over an ingested tier."""

    def __init__(self, store):
        if not getattr(store, "owns_master", False):
            raise ValueError(
                "FrozenStoreView wraps an INGESTED store (ingest the "
                "master table first, then freeze)")
        self._store = store
        self.tier = f"frozen-{store.tier}"
        self.sparse_comm = getattr(store, "sparse_comm", "off")
        self.reads = 0

    @property
    def owns_master(self) -> bool:
        return self._store.owns_master

    # -- read path: straight delegation ----------------------------------

    def route(self, keys) -> Any:
        return self._store.route(keys)

    def plan_from_window(self, window) -> FetchPlan:
        return self._store.plan_from_window(window)

    def plan(self, keys) -> FetchPlan:
        return self._store.plan(keys)

    def retrieve(self, plan: FetchPlan) -> DualBuffer:
        self.reads += 1
        return self._store.retrieve(plan)

    # -- read-tuned cache admission --------------------------------------

    def set_read_horizon(self, keys: Optional[np.ndarray]) -> None:
        """Hand the cached tier the keys visible in the request queue (plus
        the window being dispatched): it then admits exactly the chunks it
        will read again. A no-op on tiers without admission."""
        setter = getattr(self._store, "set_admission_allow", None)
        if setter is not None:
            setter(keys)

    # -- mutation paths: rejected loudly ---------------------------------

    def _reject(self, op: str):
        raise ReadOnlyStoreError(
            f"{op} on a FrozenStoreView({self._store.tier}): serving "
            "replicas are read-only — export/checkpoint from the owning "
            "training store, never through a frozen view")

    def commit(self, buffer: DualBuffer, plan: Optional[FetchPlan] = None) -> None:
        self._reject("commit")

    def ingest(self, table):
        self._reject("ingest")

    def release(self):
        self._reject("release")

    def export_table(self):
        self._reject("export_table (checkpoint write)")

    def scatter_host(self, keys, rows, accum) -> None:
        self._reject("scatter_host")

    def flush(self) -> None:
        """No-op: a frozen master has nothing to reconcile."""

    # -- metrics ----------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        out = {k: v for k, v in self._store.metrics().items()
               if k not in COMMIT_METRIC_KEYS}
        out["read_only"] = 1.0
        out["reads"] = float(self.reads)
        return out


__all__ = ["FrozenStoreView", "ReadOnlyStoreError", "COMMIT_METRIC_KEYS"]
