"""ServeRouter: dispatch coalesced windows through a frozen store.

One window trip is the DBP data path with the epilogue cut off:

    read horizon -> plan (stage 3 routing) -> retrieve (stage 4a)
                 -> head lookup (stage 5 FWP forward)

and nothing else: no commit, no gradient, no buffer rotation. Before each
window the router hands the view the keys of that window and of every
queued request (the read horizon, which a cached tier's admission uses).
Two heads:

- ``embedding``: the raw (F, D) embedding rows per request;
- ``dlrm``: the full DLRM dense forward, one logit per request.

This module does not import ``repro_torch.api`` (the api layer imports
*us*); the store and workload are handed in pre-built.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.embedding.engine import LookupPlan
from ..core.store.base import FetchPlan
from ..models.dlrm import DLRM
from .batcher import CoalescedWindow, WindowBatcher
from .view import FrozenStoreView

HEADS = ("embedding", "dlrm")


class ServeRouter:
    """Pumps windows from a :class:`WindowBatcher` through a
    :class:`FrozenStoreView` and de-interleaves per-request results."""

    def __init__(
        self,
        engine,
        view: FrozenStoreView,
        batcher: WindowBatcher,
        *,
        head: str = "embedding",
        model: Optional[DLRM] = None,
    ):
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}; expected one of {HEADS}")
        if head == "dlrm" and model is None:
            raise ValueError("head='dlrm' needs the DLRM model")
        self.engine = engine
        self.view = view
        self.batcher = batcher
        self.head = head
        self.model = model
        self.results: Dict[int, np.ndarray] = {}
        self.windows_served = 0

    # -- dispatch ---------------------------------------------------------

    def submit(self, keys: np.ndarray, dense: Optional[np.ndarray] = None) -> int:
        return self.batcher.submit(keys, dense)

    @torch.inference_mode()
    def _dispatch(self, window: CoalescedWindow) -> None:
        # the read horizon: this window's keys and every queued request's,
        # so a cached tier admits exactly the keys it will see again
        horizon = np.union1d(np.unique(window.keys),
                             self.batcher.pending_keys()).astype(np.int32)
        self.view.set_read_horizon(horizon)
        plan: FetchPlan = self.view.plan(window.keys[None])
        buffer = self.view.retrieve(plan)
        eng = self.engine
        plan0 = LookupPlan(*(x[0] for x in plan.window.plans))
        out = eng.lookup_from_buffer(buffer, plan0, window.keys.shape, 1) \
            .to(eng.compute_dtype)
        if self.head == "dlrm":
            dense = torch.as_tensor(window.dense, device=eng.device)
            out = self.model(out.to(torch.float32), dense)
        out_np = out.cpu().numpy()  # blocks: the result is real

        ovf = int(eng.overflow_metric(plan.window))
        if ovf > 0:
            raise RuntimeError(
                f"serve window overflowed the routing buffer (overflow={ovf}) "
                "— raise bucket_slack or shrink max_batch")

        t = self.batcher.clock()
        for i, req in enumerate(window.requests):  # padding rows dropped
            self.results[req.rid] = out_np[i]
            self.batcher.log.done(req.rid, t)
        self.windows_served += 1

    def pump(self, force: bool = False) -> int:
        """Serve every due window (all of them, if ``force``). Returns the
        number of windows dispatched."""
        n = 0
        while True:
            window = self.batcher.next_window(force=force)
            if window is None:
                return n
            self._dispatch(window)
            n += 1

    def drain(self) -> None:
        """Flush the queue to empty, ignoring the wait policy."""
        self.pump(force=True)

    # -- metrics ----------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        out = dict(self.batcher.log.summary())
        out["windows"] = float(self.windows_served)
        if self.windows_served:
            out["window_fill"] = round(
                self.batcher.rows_dispatched
                / (self.windows_served * self.batcher.max_batch), 4)
        sm = self.view.metrics()
        out.update(sm)
        hits, misses = sm.get("cache_hits", 0.0), sm.get("cache_misses", 0.0)
        if hits + misses > 0:
            out["cache_hit_rate"] = round(hits / (hits + misses), 4)
        return out


def build_router(
    workload,
    view: FrozenStoreView,
    *,
    model: Optional[DLRM] = None,
    head: str = "embedding",
    max_wait_ms: float = 2.0,
) -> ServeRouter:
    """Wire a router to a serve-resolved workload (n_micro must be 1: one
    request window maps to exactly one lookup plan)."""
    (n, b, f) = workload.batch_shapes["keys"][0]
    if n != 1:
        raise ValueError(
            f"serving needs fwp_microbatches=1, got a window of {n} "
            "(resolve the workload through the 'serve' strategy)")
    batcher = WindowBatcher(b, max_wait_ms)
    return ServeRouter(workload.engine, view, batcher, head=head, model=model)


__all__ = ["ServeRouter", "build_router", "HEADS"]
