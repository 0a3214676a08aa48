"""Lookahead prefetcher: plan + retrieve for step t+k while step t computes
(``repro.core.store.prefetch``, the synchronous one).

The driver tops the prefetcher up at the START of each step, so the routed
retrieval of the t+k buffer is queued on the device ahead of step t's
window: the host's enqueue runs while the device works. With ``depth=1``
this is the paper's dual-buffer schedule, one sync per step. A deeper
queue reads a master stale by more commits, so the driver calls
``resync`` on every in-flight entry at every commit (Prop. 1 generalized).
In async mode (no sync) the staleness grows to k batches.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, NamedTuple, Optional

from ..embedding.engine import DualBuffer
from .base import FetchPlan


class PrefetchEntry(NamedTuple):
    batch: Any  # staged device batch dict
    plan: FetchPlan
    buffer: DualBuffer  # retrieved (pre-sync) prefetch buffer


class Prefetcher:
    """Peeks ``depth`` batches ahead of the consumer and keeps each one's
    ``plan`` + ``retrieve`` issued."""

    def __init__(self, next_batch: Callable[[], Any], store, *, depth: int = 1):
        self.next_batch = next_batch
        self.store = store
        self.depth = max(int(depth), 1)
        self._q: "deque[PrefetchEntry]" = deque()

    def __len__(self) -> int:
        return len(self._q)

    def fill(self, limit: Optional[int] = None) -> None:
        """Top up to ``depth`` in-flight entries; ``limit`` caps the fill
        when fewer windows remain, so a finite run never routes a window
        no step consumes."""
        target = self.depth if limit is None else min(self.depth, max(limit, 0))
        while len(self._q) < target:
            batch = self.next_batch()
            plan = self.store.plan(batch["keys"])
            self._q.append(PrefetchEntry(batch, plan, self.store.retrieve(plan)))

    def pop(self) -> PrefetchEntry:
        if not self._q:
            self.fill(limit=1)
        return self._q.popleft()

    def resync(self, buf_updated: DualBuffer, sync_fn: Callable) -> None:
        """Repair every in-flight buffer against a just-committed window
        (a no-op at the paper's depth=1)."""
        self._q = deque(e._replace(buffer=sync_fn(buf_updated, e.buffer))
                        for e in self._q)
