"""Window-coalescing request batcher (the serving half of FWP).

Inference requests arrive one sample at a time; the engine's routing and
lookup want fixed-shape windows (fixed capacities, one buffer size). The batcher coalesces concurrent
requests into one FWP-style window under a max-wait/max-batch policy —
the continuous-batching scheduler split (router/service in
text-generation-inference terms), applied to embedding lookups:

- a window closes as soon as ``max_batch`` requests are queued, or when
  the OLDEST queued request has waited ``max_wait_ms`` (latency bound);
- when the backlog exceeds one window, requests are ordered by the same
  key-centric clustering training uses for micro-batches
  (``core/fwp/clustering.cluster_batch``): key-similar requests land in
  the same window, maximizing intra-window dedup so the dual buffer
  stays small and the hot-cache hit pattern stays tight. Every window
  contains the oldest queued request, so clustering can reorder but
  never starve;
- windows are always padded to exactly ``max_batch`` rows (row 0
  repeated) so route/retrieve/lookup see ONE shape — padding
  repeats real keys, so it adds no unique keys, no cache misses and no
  routing pressure; padded rows are dropped at de-interleave time.

All time comes from an injectable ``clock`` so scheduling is exactly
testable with a fake clock (no wall-time in asserts).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..core.fwp.clustering import cluster_batch


@dataclass
class ServeRequest:
    """One user lookup request: the per-sample sparse keys (+ optional
    dense features for the dlrm head)."""

    rid: int
    keys: np.ndarray  # (F,) int32 scrambled mega-table keys
    dense: Optional[np.ndarray]  # (num_dense,) f32 or None
    t_arrival: float


class CoalescedWindow(NamedTuple):
    """One fixed-shape dispatch unit: ``requests[i]`` owns row ``i`` of
    ``keys``/``dense``; rows past ``len(requests)`` are padding."""

    requests: Tuple[ServeRequest, ...]
    keys: np.ndarray  # (max_batch, F) int32
    dense: np.ndarray  # (max_batch, num_dense) f32
    t_formed: float


class LatencyLog:
    """Per-request latency bookkeeping: arrival -> dispatch -> done."""

    def __init__(self):
        self._arrive: Dict[int, float] = {}
        self._dispatch: Dict[int, float] = {}
        self._done: Dict[int, float] = {}

    def arrive(self, rid: int, t: float) -> None:
        self._arrive[rid] = t

    def dispatch(self, rid: int, t: float) -> None:
        self._dispatch[rid] = t

    def done(self, rid: int, t: float) -> None:
        self._done[rid] = t

    def latencies_ms(self) -> np.ndarray:
        """End-to-end (arrival -> result materialized) per completed rid."""
        return np.asarray([(t - self._arrive[r]) * 1e3
                           for r, t in sorted(self._done.items())])

    def waits_ms(self) -> np.ndarray:
        """Queue wait (arrival -> window formed) per dispatched rid."""
        return np.asarray([(t - self._arrive[r]) * 1e3
                           for r, t in sorted(self._dispatch.items())])

    def summary(self) -> Dict[str, float]:
        lat = self.latencies_ms()
        if not lat.size:
            return {"requests_done": 0.0}
        waits = self.waits_ms()
        return {
            "requests_done": float(lat.size),
            "latency_p50_ms": round(float(np.percentile(lat, 50)), 4),
            "latency_p99_ms": round(float(np.percentile(lat, 99)), 4),
            "latency_mean_ms": round(float(lat.mean()), 4),
            "latency_max_ms": round(float(lat.max()), 4),
            "wait_mean_ms": round(float(waits.mean()), 4) if waits.size else 0.0,
        }


class WindowBatcher:
    """Max-wait/max-batch window coalescer (see module docstring)."""

    def __init__(
        self,
        max_batch: int,
        max_wait_ms: float = 2.0,
        *,
        clock: Callable[[], float] = time.perf_counter,
        clustering: bool = True,
        cluster_scheme: str = "idf_minkey",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.clock = clock
        self.clustering = clustering
        self.cluster_scheme = cluster_scheme
        self.log = LatencyLog()
        self._queue: Deque[ServeRequest] = deque()
        self._next_rid = 0
        self.windows_formed = 0
        self.rows_dispatched = 0

    # -- intake -----------------------------------------------------------

    def submit(self, keys: np.ndarray, dense: Optional[np.ndarray] = None) -> int:
        """Enqueue one request; returns its request id."""
        keys = np.ascontiguousarray(np.asarray(keys, np.int32).reshape(-1))
        if self._queue and keys.shape != self._queue[0].keys.shape:
            raise ValueError(
                f"request key shape {keys.shape} != queued "
                f"{self._queue[0].keys.shape} (one workload per batcher)")
        if dense is not None:
            dense = np.asarray(dense, np.float32).reshape(-1)
        rid = self._next_rid
        self._next_rid += 1
        t = self.clock()
        self._queue.append(ServeRequest(rid, keys, dense, t))
        self.log.arrive(rid, t)
        return rid

    def pending(self) -> int:
        return len(self._queue)

    def pending_keys(self) -> np.ndarray:
        """Sorted unique keys of every still-queued request: the visible
        horizon the cached tier's serving admission uses."""
        if not self._queue:
            return np.empty((0,), np.int32)
        return np.unique(np.concatenate([r.keys for r in self._queue]))

    # -- window formation --------------------------------------------------

    def ready(self) -> bool:
        """A window is due: full batch queued, or the oldest request has
        waited out ``max_wait_ms``."""
        if not self._queue:
            return False
        if len(self._queue) >= self.max_batch:
            return True
        return (self.clock() - self._queue[0].t_arrival) * 1e3 >= self.max_wait_ms

    def _select(self) -> List[int]:
        """Indices (queue order) of the requests forming the next window.

        FIFO when the backlog fits one window. Above that, the backlog is
        ordered by key-centric clustering and the window is the contiguous
        cluster slice CONTAINING the oldest request — key-similar requests
        coalesce, and the head of line always drains (no starvation)."""
        n = min(len(self._queue), self.max_batch)
        if len(self._queue) <= self.max_batch or not self.clustering:
            return list(range(n))
        allk = np.stack([r.keys for r in self._queue])
        perm = cluster_batch(allk, 1, scheme=self.cluster_scheme)
        pos = int(np.flatnonzero(perm == 0)[0])  # oldest request's slot
        start = min(pos, len(perm) - n)
        return sorted(int(i) for i in perm[start:start + n])

    def next_window(self, force: bool = False) -> Optional[CoalescedWindow]:
        """Form the next window, or None when nothing is due. ``force``
        drains a partial window regardless of the wait policy."""
        if not self._queue or not (force or self.ready()):
            return None
        picked = self._select()
        picked_set = set(picked)
        reqs = list(self._queue)
        selected = tuple(reqs[i] for i in picked)
        self._queue = deque(r for i, r in enumerate(reqs)
                            if i not in picked_set)

        f = selected[0].keys.shape[0]
        keys = np.empty((self.max_batch, f), np.int32)
        nd = 0 if selected[0].dense is None else selected[0].dense.shape[0]
        dense = np.zeros((self.max_batch, nd), np.float32)
        for i, r in enumerate(selected):
            keys[i] = r.keys
            if r.dense is not None:
                dense[i] = r.dense
        # pad by repeating row 0: real keys -> no new uniques, no misses
        keys[len(selected):] = keys[0]
        dense[len(selected):] = dense[0]

        t = self.clock()
        for r in selected:
            self.log.dispatch(r.rid, t)
        self.windows_formed += 1
        self.rows_dispatched += len(selected)
        return CoalescedWindow(selected, keys, dense, t)


__all__ = ["ServeRequest", "CoalescedWindow", "LatencyLog", "WindowBatcher"]
