"""Device-local sparse-key routing primitives (fixed capacities, sentinel
padding), ported from ``repro.core.embedding.routing``.

Every function returns exactly what its JAX counterpart returns, bit for
bit. Torch has no ``mode="drop"`` scatter, so each fixed-capacity scatter
gets one spare destination slot for the dropped entries, sliced off after.

Key conventions
---------------
* ``SENTINEL`` marks an empty slot. Sentinel keys sort last (int32 max).
* Keys entering the engine are already *scrambled* (``table.py``).
* ``owner(k) = k // rows_per_shard``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SENTINEL = int(np.iinfo(np.int32).max)


class UniqueResult(NamedTuple):
    """Fixed-capacity deduplication of a local key multiset."""

    unique_keys: torch.Tensor  # (U_max,) int32, sorted ascending, SENTINEL-padded
    inverse: torch.Tensor  # (L,) int32: position -> unique slot (U_max for invalid)
    n_unique: torch.Tensor  # () int32
    overflow: torch.Tensor  # () int32: uniques dropped because U_max too small


class BucketResult(NamedTuple):
    """Owner-bucketed send layout for a unique key set."""

    send_keys: torch.Tensor  # (S, C) int32, SENTINEL-padded
    slot_of_unique: torch.Tensor  # (U_max,) int32: unique slot -> flat send slot (S*C for invalid)
    overflow: torch.Tensor  # () int32: keys dropped because C too small


def _scatter_drop(size: int, fill: int, dst: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``full(size, fill).at[dst].set(src, mode="drop")`` for flat int32
    ``src``, where every dropped entry has ``dst == size``."""
    out = torch.full((size + 1,), fill, dtype=src.dtype, device=src.device)
    out.scatter_(0, dst.reshape(-1).long(), src.reshape(-1))
    return out[:size]


def fixed_unique_window(keys: torch.Tensor, u_max: int) -> UniqueResult:
    """Window-fused sort-based dedup: N independent lookup units in ONE pass.

    ``keys``: (N, L) int32, may contain SENTINEL padding. Leaves carry a
    leading N axis; uniques beyond ``u_max`` are dropped per row (counted in
    ``overflow``).
    """
    n, L = keys.shape
    order = torch.argsort(keys, dim=1, stable=True)
    sk = torch.gather(keys, 1, order)
    valid = sk != SENTINEL
    is_new = torch.cat(
        [valid[:, :1], (sk[:, 1:] != sk[:, :-1]) & valid[:, 1:]], dim=1)
    uid_sorted = torch.cumsum(is_new, dim=1, dtype=torch.int32) - 1
    n_unique = is_new.sum(dim=1, dtype=torch.int32)

    # row r's slot u lives at r * u_max + u; out-of-capacity -> n * u_max
    row = torch.arange(n, dtype=torch.int32, device=keys.device)[:, None]
    keep = is_new & (uid_sorted < u_max)
    dst = torch.where(keep, row * u_max + uid_sorted, n * u_max)
    unique_keys = _scatter_drop(n * u_max, SENTINEL, dst, sk).reshape(n, u_max)

    # inverse map back to original positions; invalid/overflowed -> u_max
    inv_sorted = torch.where(valid & (uid_sorted < u_max), uid_sorted, u_max)
    inverse = torch.zeros((n, L), dtype=torch.int32, device=keys.device)
    inverse.scatter_(1, order, inv_sorted.to(torch.int32))
    overflow = torch.clamp(n_unique - u_max, min=0).to(torch.int32)
    return UniqueResult(unique_keys, inverse, n_unique, overflow)


def fixed_unique(keys: torch.Tensor, u_max: int) -> UniqueResult:
    """Sort-based dedup of one (L,) key row into a fixed-size buffer: the
    single-row view of :func:`fixed_unique_window`."""
    res = fixed_unique_window(keys[None], u_max)
    return UniqueResult(
        res.unique_keys[0], res.inverse[0], res.n_unique[0], res.overflow[0])


def owner_of(keys, rows_per_shard: int, num_shards: int):
    """THE ownership hash: shard that owns each (scrambled) key, sentinels
    -> the virtual shard ``num_shards``. Numpy in -> numpy out."""
    if isinstance(keys, torch.Tensor):
        owner = torch.clamp(keys // rows_per_shard, max=num_shards - 1)
        return torch.where(keys != SENTINEL, owner, num_shards)
    owner = np.minimum(keys // rows_per_shard, num_shards - 1)
    return np.where(keys != SENTINEL, owner, num_shards)


def bucket_by_owner_window(
    unique_keys: torch.Tensor, num_shards: int, capacity: int,
    rows_per_shard: int,
) -> BucketResult:
    """Window-fused owner bucketing: (N, U) sorted-unique rows -> (N, S, C).

    Rows are sorted, so owners are grouped within each row; a batched
    searchsorted gives each owner's group start.
    """
    n, u_max = unique_keys.shape
    dev = unique_keys.device
    valid = unique_keys != SENTINEL
    owner = owner_of(unique_keys, rows_per_shard, num_shards).to(torch.int32)

    shard_ids = torch.arange(num_shards + 1, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(
        owner, shard_ids.expand(n, num_shards + 1).contiguous(),
        side="left", out_int32=True)  # (N, S+1)
    pos_in_group = torch.arange(u_max, dtype=torch.int32, device=dev)[None, :] \
        - torch.gather(starts, 1, torch.clamp(owner, max=num_shards).long())
    in_cap = pos_in_group < capacity
    dest = torch.where(valid & in_cap, owner * capacity + pos_in_group,
                       num_shards * capacity)

    # one flat scatter builds all N send buffers
    row = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    flat_sc = num_shards * capacity
    dst = torch.where(dest < flat_sc, row * flat_sc + dest, n * flat_sc)
    send_keys = _scatter_drop(n * flat_sc, SENTINEL, dst, unique_keys) \
        .reshape(n, num_shards, capacity)
    overflow = (valid & ~in_cap).sum(dim=1, dtype=torch.int32)
    return BucketResult(send_keys, dest.to(torch.int32), overflow)


def bucket_by_owner(
    unique_keys: torch.Tensor, num_shards: int, capacity: int,
    rows_per_shard: int,
) -> BucketResult:
    """Bucket sorted-unique keys by destination shard into (S, C) send
    buffers: the single-row view of :func:`bucket_by_owner_window`."""
    res = bucket_by_owner_window(
        unique_keys[None], num_shards, capacity, rows_per_shard)
    return BucketResult(res.send_keys[0], res.slot_of_unique[0], res.overflow[0])


def sorted_lookup(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Index of each query in a sorted sentinel-padded key buffer, or
    ``len(sorted_keys)`` (== miss) for queries not present."""
    n = sorted_keys.shape[0]
    idx = torch.searchsorted(sorted_keys, queries, side="left", out_int32=True)
    idx_c = torch.clamp(idx, max=n - 1)
    hit = (sorted_keys[idx_c.long()] == queries) & (queries != SENTINEL)
    return torch.where(hit, idx_c, n).to(torch.int32)


def merge_sorted_unique(key_sets: torch.Tensor, out_cap: int) -> torch.Tensor:
    """Union of several sentinel-padded key sets -> sorted unique (out_cap,)."""
    return fixed_unique(key_sets.reshape(-1), out_cap).unique_keys


def intersect_sorted(keys_a: torch.Tensor, keys_b: torch.Tensor) -> torch.Tensor:
    """For each slot of ``keys_b``, the matching slot in ``keys_a`` (or
    len(a)). Both inputs sorted + sentinel padded."""
    return sorted_lookup(keys_a, keys_b)
