"""SparseComm: the host tiers' sparse-path wire policy and byte ledger
(``repro.core.store.comm``).

Three modes, chosen by ``NestPipeConfig.sparse_comm``,
``$REPRO_SPARSE_COMM`` or ``Session.from_arch(sparse_comm=...)`` (argument
> environment > ``"off"``):

``off``
    Keys and rows move as they are. The counters still run, so every
    mode's bytes are a recorded number.
``pack`` (lossless, bit for bit)
    The sorted-unique key list of the stage-3 pull round-trips through the
    bit-packed delta codec (``dist.compressed.pack_sorted_keys``; the
    store plans from the unpacked result, so the codec is on the path),
    the cached tier's staging pads narrow from its 64-row miss bucket to
    the 8-row occupied prefix (``PACK_PAD``), and its index vectors go on
    the wire in the narrowest unsigned dtype; the store casts them back to
    int32 on the card before a kernel sees them. Values never change:
    ``pack`` replays ``off`` bit for bit, only the byte counters shrink.
``int8`` (approximate, and labelled so everywhere)
    Staged rows quantize to per-row int8 with an f32 scale on the way to
    the card (in place, so the card sees exactly what the wire would
    carry), and commit write-back deltas quantize the same way with an
    error-feedback residual. On top, frequency-aware selective sync: a row
    past ``hot_threshold`` commits syncs every window, a colder one with a
    probability proportional to its frequency (at least ``min_sync_p``),
    drawn from ``np.random.default_rng(seed)`` in the JAX package's call
    order; a skipped sync banks the whole delta in the residual, so an
    update is delayed, never lost. Keys stay exact, and the pads narrow as
    under ``pack``.

Counters (``counters()``, merged into each store's ``metrics()``):
``wire_bytes`` the key payload in the mode's form, ``idx_bytes`` the
staged index vectors, and under ``int8`` ``comm_rows_synced``,
``comm_rows_deferred`` and ``comm_state_chunks``. With one shard they
count the modeled payload, as in the JAX package.

Exactness boundary: eviction write-back and ``flush`` stay full precision
in every mode; they spill the authoritative cache copy.

The multi-shard exchange (``num_slices > 1``, per-axis bytes) belongs to
the sharded tier (``ROADMAP.md``, port Queue 1, item 6) and raises here.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np

from ...dist.compressed import (
    min_index_dtype,
    pack_sorted_keys,
    quantize_rows_np,
    unpack_sorted_keys,
)
from ..embedding.routing import SENTINEL

SPARSE_COMMS = ("off", "pack", "int8")

# Staging pad under pack / int8: the occupied prefix rounded to 8 rows.
PACK_PAD = 8


def _numpy(a):
    """A numpy view of a CPU tensor (or the array itself): the int8 path
    writes the staged rows in place."""
    return a if isinstance(a, np.ndarray) else a.numpy()


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
    """One store's sparse-path policy and byte ledger.

    ``exchange_keys`` and the staging calls run on the driver or a stage
    worker; ``writeback`` only on the ordered commit path, so the int8
    residual and frequency state has one writer. The byte counters take a
    lock.
    """

    def __init__(self, mode: Optional[str] = None, *,
                 hot_threshold: int = 4, min_sync_p: float = 0.1,
                 seed: int = 0):
        self.mode = resolve_sparse_comm(mode)
        self.lossy = self.mode == "int8"
        self.hot_threshold = max(int(hot_threshold), 1)
        self.min_sync_p = float(min(max(min_sync_p, 0.0), 1.0))
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.wire_bytes = 0
        self.idx_bytes = 0
        self.rows_synced = 0
        self.rows_deferred = 0
        # int8 frequency and residual state, chunk-keyed and made on first
        # touch: chunk id -> slot; slot s is row s % B of block s // B,
        # each block (freq (B, C), residual (B, C, D)). The values and the
        # RNG's call order are those of the JAX package's dict of chunks.
        self._state_chunks: Dict[int, int] = {}
        self._state_blocks: List[tuple] = []

    # -- key exchange (the stage-3 pull) ----------------------------------

    def exchange_keys(self, host_keys: np.ndarray, num_slices: int = 1,
                      axes: Optional[tuple] = None) -> np.ndarray:
        """Carry the owner-side union key list through the mode's codec and
        count its payload. Under pack / int8 the sentinel suffix is elided
        from the wire (only its length travels, inside the modeled header):
        sentinels sort last, so the list is a sorted valid prefix and
        ``SENTINEL * m``, and the suffix comes back exactly."""
        if num_slices > 1 or axes:
            raise NotImplementedError(
                "a multi-shard key exchange belongs to the sharded tier, not "
                "ported yet (ROADMAP.md, port Queue 1, item 6)")
        if self.mode == "off":
            with self._lock:
                self.wire_bytes += int(host_keys.nbytes)
            return host_keys
        nv = int(np.searchsorted(host_keys, SENTINEL))  # first sentinel slot
        packed = pack_sorted_keys(host_keys[:nv])
        out = np.full(host_keys.shape, SENTINEL, host_keys.dtype)
        out[:nv] = unpack_sorted_keys(packed, host_keys.dtype)
        with self._lock:
            self.wire_bytes += packed.nbytes
        return out

    # -- staging (pads, index vectors, int8 rows) -------------------------

    def _pad(self, bucket: int) -> int:
        return bucket if self.mode == "off" else min(PACK_PAD, bucket)

    def pad_rows(self, n: int, bucket: int) -> int:
        """Staging pad for ``n`` occupied rows: a multiple of the store's
        ``bucket`` under ``off``, of 8 rows under pack / int8."""
        if n <= 0:
            return 0
        pad = self._pad(bucket)
        return -(-n // pad) * pad

    def pad_chunks(self, n: int, bucket: int, chunk_rows: int) -> int:
        """Staging pad for ``n`` occupied chunks of ``chunk_rows`` rows: the
        row pad divided down to chunk units, at least one chunk. At
        ``chunk_rows=1`` this is :meth:`pad_rows`."""
        if n <= 0:
            return 0
        g = max(self._pad(bucket) // max(int(chunk_rows), 1), 1)
        return -(-n // g) * g

    def pack_index(self, idx: np.ndarray, max_val: int) -> np.ndarray:
        """An index vector for a staged device gather or scatter in the
        mode's wire dtype (int32 under ``off``, the narrowest unsigned
        dtype holding ``max_val`` otherwise: the card casts it back),
        counted into ``idx_bytes``."""
        if self.mode != "off":
            idx = idx.astype(min_index_dtype(max_val))
        with self._lock:
            self.idx_bytes += int(idx.nbytes)
        return idx

    def stage_payload(self, rows, accum) -> int:
        """The H2D payload bytes of a staged buffer (host arrays or CPU
        tensors); under int8 the rows quantize and dequantize in place
        first."""
        if self.mode != "int8":
            return int(rows.nbytes) + int(accum.nbytes)
        rows = _numpy(rows)
        q, scales, _ = quantize_rows_np(rows)
        rows[:] = q.astype(np.float32) * scales[:, None]
        return int(q.nbytes) + int(scales.nbytes) + int(accum.nbytes)

    def stage_chunk_payload(self, rows, accum, hot_idx: np.ndarray) -> int:
        """The chunk-burst form of :meth:`stage_payload`: under int8 only
        the accessed rows (``hot_idx`` into the burst) quantize; the
        co-resident rows ride at full precision."""
        if self.mode != "int8":
            return int(rows.nbytes) + int(accum.nbytes)
        rows = _numpy(rows)
        nh = int(hot_idx.shape[0])
        row_bytes = int(rows.dtype.itemsize) * int(rows.shape[1])
        if nh:
            q, scales, _ = quantize_rows_np(rows[hot_idx])
            rows[hot_idx] = q.astype(np.float32) * scales[:, None]
            hot_bytes = int(q.nbytes) + int(scales.nbytes)
        else:
            hot_bytes = 0
        cold_bytes = (int(rows.shape[0]) - nh) * row_bytes
        return hot_bytes + cold_bytes + int(accum.nbytes)

    # -- int8 commit: selective sync of quantized deltas -------------------

    _STATE_CHUNK = 64  # rows a state chunk
    _STATE_BLOCK = 1024  # chunks a block: the unit the state grows by

    def _slots(self, keys: np.ndarray, dim: int, make: bool):
        """Each key's state slot (its chunk's; -1 for a chunk never
        touched, unless ``make`` gives it one) and its offset in the
        chunk. Slots live in blocks of ``_STATE_BLOCK`` chunks, so a call
        costs one dict lookup a distinct chunk and array ops, not a pass
        over the keys a chunk."""
        c = keys // self._STATE_CHUNK
        off = keys % self._STATE_CHUNK
        u, inv = np.unique(c, return_inverse=True)
        get = self._state_chunks.get
        us = np.fromiter((get(x, -1) for x in u.tolist()), np.int64, count=u.size)
        new = np.flatnonzero(us < 0) if make else ()
        if len(new):
            first = len(self._state_chunks)
            us[new] = np.arange(first, first + len(new))
            self._state_chunks.update(zip(u[new].tolist(), us[new].tolist()))
            while len(self._state_blocks) * self._STATE_BLOCK < first + len(new):
                self._state_blocks.append((
                    np.zeros((self._STATE_BLOCK, self._STATE_CHUNK), np.int64),
                    np.zeros((self._STATE_BLOCK, self._STATE_CHUNK, dim), np.float32)))
        return us[inv.reshape(-1)], off

    def _by_block(self, slot: np.ndarray):
        """``(freq, residual)`` of each block the slots reach, the positions
        of its keys (in key order) and their slots within it."""
        blk = slot // self._STATE_BLOCK
        for b in np.unique(blk[slot >= 0]).tolist():
            pos = np.flatnonzero(blk == b)
            yield self._state_blocks[b], pos, slot[pos] - b * self._STATE_BLOCK

    def _bump_freq_get_residual(self, keys: np.ndarray, dim: int):
        """``freq[keys] += 1``, then the (freq, residual) rows of ``keys``."""
        n = int(keys.shape[0])
        slot, off = self._slots(keys, dim, make=True)
        f = np.empty(n, np.int64)
        resid = np.empty((n, dim), np.float32)
        for (freq, res), pos, i in self._by_block(slot):
            o = off[pos]
            freq[i, o] += 1
            f[pos] = freq[i, o]
            resid[pos] = res[i, o]
        return f, resid

    def _residual_scatter(self, keys: np.ndarray, vals: np.ndarray,
                          dim: int) -> None:
        slot, off = self._slots(keys, dim, make=True)
        for (_, res), pos, i in self._by_block(slot):
            res[i, off[pos]] = vals[pos]

    def residual_rows(self, keys: np.ndarray, dim: int) -> np.ndarray:
        """The residual rows of ``keys`` (untouched chunks read zeros)."""
        out = np.zeros((int(keys.shape[0]), dim), np.float32)
        slot, off = self._slots(keys, dim, make=False)
        for (_, res), pos, i in self._by_block(slot):
            out[pos] = res[i, off[pos]]
        return out

    def writeback(self, keys: np.ndarray, rows: np.ndarray,
                  accum: np.ndarray, master_rows: np.ndarray,
                  master_accum: np.ndarray) -> int:
        """The int8 commit of ``keys`` (valid, unique row ids) into the
        numpy views of the master, in place; returns the modeled D2H bytes
        (the synced rows' int8 values, scales, keys and adagrad state; a
        deferred row moves nothing).

        A synced row gets ``dequantize(quantize(delta + residual))`` and
        keeps the new quantization error as its residual; a deferred row
        banks the whole payload. The adagrad state is absolute, exact at
        the row's next sync."""
        n = int(keys.shape[0])
        if not n:
            return 0
        dim = int(master_rows.shape[1])
        f, resid = self._bump_freq_get_residual(keys, dim)
        p = np.clip(f / self.hot_threshold, self.min_sync_p, 1.0)
        sync = (f >= self.hot_threshold) | (self._rng.random(n) < p)
        payload = np.asarray(rows, np.float32) - master_rows[keys] + resid
        ks = keys[sync]
        nbytes = 0
        if ks.size:
            q, scales, err = quantize_rows_np(payload[sync])
            master_rows[ks] += q.astype(np.float32) * scales[:, None]
            master_accum[ks] = accum[sync]
            self._residual_scatter(ks, err, dim)
            nbytes = int(q.nbytes) + int(scales.nbytes) + int(ks.size * 4)
        kd = keys[~sync]
        if kd.size:
            self._residual_scatter(kd, payload[~sync], dim)
        with self._lock:
            self.rows_synced += int(ks.size)
            self.rows_deferred += int(kd.size)
        return nbytes

    # -- counters ----------------------------------------------------------

    def counters(self) -> Dict[str, float]:
        with self._lock:
            out = {"wire_bytes": float(self.wire_bytes),
                   "idx_bytes": float(self.idx_bytes)}
            if self.lossy:
                out["comm_rows_synced"] = float(self.rows_synced)
                out["comm_rows_deferred"] = float(self.rows_deferred)
                out["comm_state_chunks"] = float(len(self._state_chunks))
        return out


__all__ = ["SPARSE_COMMS", "PACK_PAD", "SparseComm", "resolve_sparse_comm"]
