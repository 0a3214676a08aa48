"""Key-centric sample clustering (paper §V-C), a numpy copy of
``repro.core.fwp.clustering``: the same keys give the same permutation.

Partition a batch's samples so samples sharing sparse keys land in the
same micro-batch (or serving window), maximizing intra-unit key dedup.
Clustering only permutes samples.
"""
from __future__ import annotations

import numpy as np

_MIX1 = np.uint64(0x9E3779B97F4A7C15)
_MIX2 = np.uint64(0xBF58476D1CE4E5B9)


def _hash_keys(keys: np.ndarray, salt: int) -> np.ndarray:
    """Cheap 64-bit mix of int keys (vectorized, numpy; wrapping uint64)."""
    with np.errstate(over="ignore"):
        x = keys.astype(np.uint64) + np.uint64(salt) * _MIX1
        x ^= x >> np.uint64(30)
        x *= _MIX2
        x ^= x >> np.uint64(27)
    return x


def minhash_signature(sample_keys: np.ndarray, num_hashes: int = 4,
                      pad_key: int | None = None) -> np.ndarray:
    """(B, F) int keys -> (B, num_hashes) uint64 minhash signatures;
    ``pad_key`` entries are ignored (they hash to the max value)."""
    B = sample_keys.shape[0]
    flat = sample_keys.reshape(B, -1)
    sigs = np.empty((B, num_hashes), np.uint64)
    for h in range(num_hashes):
        hv = _hash_keys(flat, salt=h + 1)
        if pad_key is not None:
            hv = np.where(flat == pad_key, np.uint64(0xFFFFFFFFFFFFFFFF), hv)
        sigs[:, h] = hv.min(axis=1)
    return sigs


# Above this flat key-block size the sort+searchsorted frequency pass beats
# ``np.unique(return_inverse=...)``.
_SORT_FREQ_MIN_SIZE = 65536


def _key_freq(flat: np.ndarray) -> tuple:
    """Exact per-element batch frequency of ``flat``'s keys plus the unique
    counts vector (``np.unique`` semantics)."""
    if flat.size < _SORT_FREQ_MIN_SIZE:
        uniq, inv, counts = np.unique(flat, return_inverse=True,
                                      return_counts=True)
        return counts[inv].reshape(flat.shape), counts
    srt = np.sort(flat, axis=None)
    edge = np.empty(srt.shape[0], bool)
    edge[0] = True
    np.not_equal(srt[1:], srt[:-1], out=edge[1:])
    starts = np.flatnonzero(edge)
    uniq = srt[starts]
    counts = np.diff(np.append(starts, srt.shape[0]))
    return counts[np.searchsorted(uniq, flat)], counts


def _key_freq_hashed(flat: np.ndarray, bits: int = 16) -> np.ndarray:
    """Approximate per-element frequency via hash-bucket counting."""
    mask = np.uint64((1 << bits) - 1)
    h = (_hash_keys(flat, 1) & mask).astype(np.int64)
    counts = np.bincount(h.ravel(), minlength=1 << bits)
    return counts[h]


def cluster_batch(sample_keys: np.ndarray, n_micro: int, *,
                  scheme: str = "idf_minkey", num_hashes: int = 4,
                  pad_key: int | None = None,
                  hot_quantile: float = 0.9) -> np.ndarray:
    """Return a permutation (B,) of sample indices; reshaping the permuted
    batch into (N, B/N, ...) yields the clustered micro-batches.

    Schemes: ``idf_minkey`` (sort by each sample's smallest keys after
    demoting globally hot keys), ``idf_hash`` (the same with approximate
    hashed counts), ``minkey`` (raw smallest keys), ``minhash``.
    """
    B = sample_keys.shape[0]
    assert B % n_micro == 0, (B, n_micro)
    flat = sample_keys.reshape(B, -1)
    if pad_key is not None:
        flat = np.where(flat == pad_key, np.iinfo(flat.dtype).max, flat)
    if scheme in ("idf_minkey", "idf_hash"):
        if scheme == "idf_minkey":
            freq, counts = _key_freq(flat)
            thresh = np.quantile(counts, hot_quantile)
        else:
            freq = _key_freq_hashed(flat)
            thresh = np.quantile(freq, hot_quantile)
        masked = np.where(freq <= thresh, flat, np.iinfo(flat.dtype).max)
        h = min(num_hashes, flat.shape[1])
        sigs = np.sort(masked, axis=1)[:, :h]
    elif scheme == "minkey":
        h = min(num_hashes, flat.shape[1])
        sigs = np.sort(flat, axis=1)[:, :h]
    else:
        h = num_hashes
        sigs = minhash_signature(sample_keys, num_hashes, pad_key)
    perm = np.lexsort(tuple(sigs[:, c] for c in reversed(range(h))))
    return perm.astype(np.int32)
