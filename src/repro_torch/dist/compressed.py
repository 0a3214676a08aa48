"""Host-side codecs of the sparse data path (``repro.dist.compressed``, its
numpy half), used by :class:`~repro_torch.core.store.comm.SparseComm`.

``pack_sorted_keys`` / ``unpack_sorted_keys``
    Lossless bit-packed delta coding of a sorted nondecreasing key list
    (the stage-3 key pull is sorted-unique with the int32-max sentinel
    padding its tail): the first key plus ``n - 1`` deltas at the smallest
    bit width that holds the largest delta. The ``pack`` mode stands on it.
``quantize_rows_np`` / ``dequantize_rows_np``
    Per-row symmetric int8 with one f32 scale a row (``max|row| / 127``).
    The round-trip error is at most half a scale an element and comes back
    explicitly, so a caller can carry it as an error-feedback residual (the
    ``int8`` mode).
``min_index_dtype``
    The narrowest unsigned dtype of an index vector on the wire.

The quantized ring all-reduce of the dense gradients is not here: it
belongs to the multi-rank path (``ROADMAP.md``, port Queue 1, item 6).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

# Modeled per-message header of a packed key payload: count + first key +
# bit width (8 + 8 + 1 bytes, rounded to 16). Byte accounting, not a format.
PACK_HEADER_BYTES = 16


def quantize_rows_np(rows: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row symmetric int8: ``(q, scales, error)`` with ``q`` int8 of
    ``rows.shape``, ``scales`` f32 of shape ``(n,)`` and ``error = rows -
    dequantize(q, scales)`` (at most ``scale / 2`` an element: nothing
    clips, only rounding loses). An all-zero row quantizes exactly."""
    rows = np.asarray(rows, np.float32)
    if rows.ndim != 2:
        raise ValueError(f"quantize_rows_np expects (n, d) rows, got "
                         f"{rows.shape}")
    scales = np.abs(rows).max(axis=1) / 127.0
    scales = np.maximum(scales, 1e-30).astype(np.float32)
    q = np.clip(np.rint(rows / scales[:, None]), -127, 127).astype(np.int8)
    deq = q.astype(np.float32) * scales[:, None]
    return q, scales, rows - deq


def dequantize_rows_np(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * np.asarray(scales, np.float32)[:, None]


class PackedKeys(NamedTuple):
    """A sorted nondecreasing int list as first key + bit-packed deltas."""

    data: np.ndarray  # uint8, ceil((n - 1) * width / 8) bytes of deltas
    n: int  # element count
    first: int  # keys[0]
    width: int  # bits a delta (the least that holds the largest; >= 1)

    @property
    def nbytes(self) -> int:
        """Modeled wire bytes: the packed payload and the header."""
        return int(self.data.nbytes) + PACK_HEADER_BYTES


def pack_sorted_keys(keys: np.ndarray) -> PackedKeys:
    """Delta-encode a sorted NONDECREASING integer array into bit-packed
    form at the least width. Raises on a decreasing pair."""
    keys = np.asarray(keys)
    if keys.ndim != 1:
        raise ValueError(f"pack_sorted_keys expects a 1-D array, got "
                         f"{keys.shape}")
    n = int(keys.shape[0])
    if n == 0:
        return PackedKeys(np.zeros(0, np.uint8), 0, 0, 0)
    k64 = keys.astype(np.int64)
    first = int(k64[0])
    if n == 1:
        return PackedKeys(np.zeros(0, np.uint8), 1, first, 0)
    deltas = np.diff(k64)
    if (deltas < 0).any():
        raise ValueError("pack_sorted_keys needs a nondecreasing array")
    width = max(int(deltas.max()).bit_length(), 1)
    shifts = np.arange(width, dtype=np.uint64)
    bits = ((deltas[:, None].astype(np.uint64) >> shifts) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1))
    return PackedKeys(data, n, first, width)


def unpack_sorted_keys(packed: PackedKeys, dtype=np.int64) -> np.ndarray:
    """Exact inverse of :func:`pack_sorted_keys`."""
    if packed.n == 0:
        return np.zeros(0, dtype)
    if packed.n == 1:
        return np.full(1, packed.first, dtype)
    nbits = (packed.n - 1) * packed.width
    bits = np.unpackbits(packed.data)[:nbits].reshape(packed.n - 1,
                                                      packed.width)
    shifts = np.arange(packed.width, dtype=np.int64)
    deltas = (bits.astype(np.int64) << shifts).sum(axis=1)
    out = np.empty(packed.n, np.int64)
    out[0] = packed.first
    np.cumsum(deltas, out=out[1:])
    out[1:] += packed.first
    return out.astype(dtype)


def min_index_dtype(max_val: int) -> np.dtype:
    """Smallest unsigned dtype that holds indices in ``[0, max_val]``."""
    for dt in (np.uint8, np.uint16, np.uint32):
        if max_val <= np.iinfo(dt).max:
            return np.dtype(dt)
    return np.dtype(np.int64)


__all__ = [
    "PACK_HEADER_BYTES",
    "PackedKeys",
    "dequantize_rows_np",
    "min_index_dtype",
    "pack_sorted_keys",
    "quantize_rows_np",
    "unpack_sorted_keys",
]
