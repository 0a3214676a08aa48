"""Host-side input pipeline: DBP stages 1-2 (``repro.data.pipeline`` in
PyTorch).

Stage 1 (data prefetch): a background thread pulls batches from the source
iterator, applies key-centric clustering (FWP §V-C, part of preprocessing
so its cost hides behind the pipeline) and places staged numpy batches in
a bounded queue.

Stage 2 (H2D): ``stage_to_device`` copies each field through pinned host
memory with ``non_blocking=True``, so the copy is queued on the current
stream behind the device's work and the host moves on.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..core.fwp.clustering import cluster_batch


class PrefetchQueue:
    """Bounded background prefetcher (DBP stage 1). ``close`` stops the
    thread; the driver calls it when a run ends."""

    def __init__(self, source: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._source = source
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._transform = transform
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the next get()
            self._exc = e

    def get(self, timeout: float = 60.0):
        if self._exc is not None:
            raise self._exc
        item = self._queue.get(timeout=timeout)
        if self._exc is not None:
            raise self._exc
        return item

    def close(self, timeout: float = 5.0):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)


def make_cluster_transform(n_micro: int, clustering: str,
                           keys_field: str = "keys",
                           raw_field: str = "raw_keys"):
    """Batch transform: permute samples by key-centric clustering and split
    into (N, B/N, ...) stacked micro-batches (host-side, numpy)."""

    def transform(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        ref = batch.get(raw_field, batch[keys_field])
        b = ref.shape[0]
        if clustering == "keycentric":
            perm = cluster_batch(ref.reshape(b, -1), n_micro)
        else:
            perm = np.arange(b, dtype=np.int32)
        out = {}
        for k, v in batch.items():
            pv = v[perm]
            out[k] = pv.reshape((n_micro, b // n_micro) + pv.shape[1:])
        return out

    return transform


def stage_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """DBP stage 2: each field to ``device``. On CUDA through pinned host
    memory with a non-blocking copy (the caching host allocator keeps the
    pinned block until the copy is done); on the CPU the numpy buffer is
    shared as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            .to(device, non_blocking=True) for k, v in batch.items()}
