"""SparseComm: the host tiers' sparse-path wire policy and byte ledger
(``repro.core.store.comm``), in its ``off`` mode.

``off`` is the uncompressed path: keys and rows move as they are, and the
counters still run so that every tier reports what its exchange carried:
``wire_bytes`` the owner-side key list of each plan (the stage-3 pull),
``idx_bytes`` the index vectors the cached tier stages for its device
gathers and scatters. With one shard they count the modeled payload, as
in the JAX package.

``pack`` (bit-packed key deltas, narrowed staging pads) and ``int8``
(quantized rows with selective sync) are not ported yet: they raise,
naming ``ROADMAP.md`` port Queue 1, item 2.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np

SPARSE_COMMS = ("off", "pack", "int8")

# What a mode that is not ported answers.
SPARSE_COMM_NOT_PORTED = (
    "sparse_comm={mode!r} is not ported yet: only 'off' runs in the port "
    "(ROADMAP.md, port Queue 1, item 2: async stages and sparse comm)")


def resolve_sparse_comm(mode: Optional[str] = None) -> str:
    """Resolve a sparse-comm mode: explicit arg > $REPRO_SPARSE_COMM >
    "off"."""
    for cand in (mode, os.environ.get("REPRO_SPARSE_COMM")):
        if cand and cand != "auto":
            if cand not in SPARSE_COMMS:
                raise ValueError(
                    f"unknown sparse_comm mode {cand!r}; expected one of "
                    f"{SPARSE_COMMS} or 'auto'")
            return cand
    return "off"


class SparseComm:
    """One store's sparse-path policy and byte ledger (``off`` only)."""

    def __init__(self, mode: Optional[str] = None):
        self.mode = resolve_sparse_comm(mode)
        if self.mode != "off":
            raise NotImplementedError(SPARSE_COMM_NOT_PORTED.format(mode=self.mode))
        self._lock = threading.Lock()
        self.wire_bytes = 0
        self.idx_bytes = 0

    def exchange_keys(self, host_keys: np.ndarray) -> np.ndarray:
        """Count the owner-side union key list's payload; the keys pass
        through unchanged."""
        with self._lock:
            self.wire_bytes += int(host_keys.nbytes)
        return host_keys

    def pad_rows(self, n: int, bucket: int) -> int:
        """Staging pad for ``n`` occupied rows: a multiple of ``bucket``."""
        if n <= 0:
            return 0
        return -(-n // bucket) * bucket

    def pad_chunks(self, n: int, bucket: int, chunk_rows: int) -> int:
        """Staging pad for ``n`` occupied chunks of ``chunk_rows`` rows: the
        row bucket divided down to chunk units, at least one chunk. At
        ``chunk_rows=1`` this is :meth:`pad_rows`."""
        if n <= 0:
            return 0
        g = max(bucket // max(int(chunk_rows), 1), 1)
        return -(-n // g) * g

    def pack_index(self, idx: np.ndarray, max_val: int) -> np.ndarray:
        """An index vector for a staged device gather or scatter, as it
        goes on the wire (int32 under ``off``); counted into
        ``idx_bytes``."""
        with self._lock:
            self.idx_bytes += int(idx.nbytes)
        return idx

    def stage_payload(self, rows, accum) -> int:
        """H2D payload bytes of a staged buffer (rows and accumulators as
        they are)."""
        return int(rows.nbytes) + int(accum.nbytes)

    def stage_chunk_payload(self, rows, accum, hot_idx: np.ndarray) -> int:
        """The chunk-burst form of :meth:`stage_payload` (``hot_idx``, the
        accessed rows, only matters to a quantizing mode)."""
        return int(rows.nbytes) + int(accum.nbytes)

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return {"wire_bytes": float(self.wire_bytes),
                    "idx_bytes": float(self.idx_bytes)}


__all__ = ["SPARSE_COMMS", "SparseComm", "resolve_sparse_comm"]
