"""CachePolicy: the cached tier's victim-selection / admission seam
(``repro.core.store.policy``, line for line: the numpy lexsort tie-breaks
decide which chunks are evicted and match the JAX package's).

The chunked :class:`~repro_torch.core.store.cached.CachedStore` asks a policy
three questions per retrieve — which missed chunks deserve admission
(``admit_mask``), in what order candidates and victims rank (``admit_order``
/ ``victim_order``), and whether a candidate may displace a given resident
victim (``displace``) — and feeds it one ``touch`` per retrieve with the
unique chunks the window accessed. Everything a policy remembers is a
CHUNK-KEYED SPARSE map (plain dicts), so host memory scales with the live
key set, not ``spec.padded_rows`` — the point of the chunked layout for
unbounded vocabularies.

Value-transparency holds for every policy: a policy only picks WHICH chunks
are HBM-resident, never what their bytes are, so training through any
policy replays the host tier bit for bit (tests/test_torch_cache_policy.py).

``freq``
    The baseline scheme: admit a chunk once its access count
    reaches ``admit_threshold``; evict the coldest chunk outside the
    current window, and only for a STRICTLY hotter candidate (the zipf
    tail cannot thrash the hot set). At ``cache_chunk_rows=1`` this is the
    row-granular frequency policy move for move.
``lfu``
    Classic frequency: admit on first touch, displace a victim whenever
    the candidate's count is at least the victim's (ties go to the
    candidate — it is the one in demand right now).
``lru``
    Classic recency: admit on first touch, always displace the
    least-recently-touched victim outside the current window.
``oracle``
    BagPipe-style lookahead on the TRAINING path: the store feeds it the
    union of the last ``lookahead+1`` retrieved windows — exactly the
    window set in flight between the Prefetcher's retrieval front and the
    compute front. Admission is unconditional (every miss is in the
    horizon by construction); the lookahead pays on EVICTION, Belady
    style — residents no in-flight window mentions go first, and an
    in-horizon resident refuses to yield unless the horizon wants the
    candidate strictly more. The serving path's allow-list
    (``set_admission_allow``) overrides every policy: an explicit horizon
    beats an inferred one.

Selected via ``NestPipeConfig.cache_policy`` / ``$REPRO_CACHE_POLICY`` /
``Session.from_arch(cache_policy=...)`` — the same arg > env > default
resolution as ``store`` and ``sparse_comm``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

CACHE_POLICIES = ("freq", "lfu", "lru", "oracle")


def resolve_cache_policy(policy: Optional[str] = None) -> str:
    """Resolve a cache policy name: explicit arg > $REPRO_CACHE_POLICY >
    "freq" — the ``resolve_sparse_comm`` resolution order."""
    for cand in (policy, os.environ.get("REPRO_CACHE_POLICY")):
        if cand and cand != "auto":
            if cand not in CACHE_POLICIES:
                raise ValueError(
                    f"unknown cache_policy {cand!r}; expected one of "
                    f"{CACHE_POLICIES} or 'auto'")
            return cand
    return "freq"


class CachePolicy:
    """Base: chunk-keyed access counts + recency clock (sparse dicts)."""

    name = "base"

    def __init__(self, admit_threshold: int = 1):
        self.admit_threshold = max(int(admit_threshold), 1)
        self._count: Dict[int, int] = {}
        self._last: Dict[int, int] = {}
        self._clock = 0

    # -- bookkeeping ------------------------------------------------------

    def touch(self, chunks: np.ndarray, counts: np.ndarray) -> None:
        """One retrieve: ``chunks`` are the window's unique chunk ids,
        ``counts`` how many distinct buffer keys landed in each."""
        self._clock += 1
        for c, n in zip(chunks.tolist(), counts.tolist()):
            self._count[c] = self._count.get(c, 0) + n
            self._last[c] = self._clock

    def counts(self, chunks: np.ndarray) -> np.ndarray:
        return np.array([self._count.get(c, 0) for c in chunks.tolist()],
                        np.int64)

    def lasts(self, chunks: np.ndarray) -> np.ndarray:
        return np.array([self._last.get(c, 0) for c in chunks.tolist()],
                        np.int64)

    def set_horizon(self, counts: Optional[Dict[int, int]]) -> None:
        """Lookahead horizon (chunk -> occurrence count); only ``oracle``
        reads it, but the store publishes it unconditionally so policies
        can be swapped without re-plumbing."""

    def reset(self) -> None:
        """Fresh ingest: counts, recency and clock restart cold
        (eviction, by contrast, keeps counts)."""
        self._count.clear()
        self._last.clear()
        self._clock = 0

    def state_chunks(self) -> int:
        """Live chunk entries (the sparse-map footprint metric)."""
        return len(self._count)

    # -- the three policy questions --------------------------------------

    def admit_mask(self, chunks: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def admit_order(self, chunks: np.ndarray) -> np.ndarray:
        """Candidate positions, most-deserving first (ties broken on the
        chunk id, deterministically)."""
        return np.lexsort((chunks, -self.counts(chunks)))

    def victim_order(self, chunks: np.ndarray) -> np.ndarray:
        """Resident-victim positions, coldest first."""
        return np.lexsort((chunks, self.counts(chunks)))

    def displace(self, cand: np.ndarray, victims: np.ndarray) -> np.ndarray:
        """Elementwise: may ``cand[i]`` (hottest-first) evict
        ``victims[i]`` (coldest-first)? The store stops at the first
        refusal."""
        raise NotImplementedError


class FreqPolicy(CachePolicy):
    name = "freq"

    def admit_mask(self, chunks):
        return self.counts(chunks) >= self.admit_threshold

    def displace(self, cand, victims):
        return self.counts(cand) > self.counts(victims)


class LfuPolicy(CachePolicy):
    name = "lfu"

    def admit_mask(self, chunks):
        return np.ones(chunks.shape[0], bool)

    def displace(self, cand, victims):
        return self.counts(cand) >= self.counts(victims)


class LruPolicy(CachePolicy):
    name = "lru"

    def admit_mask(self, chunks):
        return np.ones(chunks.shape[0], bool)

    def victim_order(self, chunks):
        return np.lexsort((chunks, self.lasts(chunks)))

    def displace(self, cand, victims):
        # A miss is by definition the most recent access: always displace
        # the stalest resident (window-protection still guards in-flight
        # chunks at the store layer).
        return np.ones(min(cand.shape[0], victims.shape[0]), bool)


class OraclePolicy(CachePolicy):
    name = "oracle"

    def __init__(self, admit_threshold: int = 1):
        super().__init__(admit_threshold)
        self._horizon: Dict[int, int] = {}

    def set_horizon(self, counts):
        self._horizon = counts or {}

    def reset(self):
        super().reset()
        self._horizon = {}

    def _hcounts(self, chunks: np.ndarray) -> np.ndarray:
        return np.array([self._horizon.get(c, 0) for c in chunks.tolist()],
                        np.int64)

    def admit_mask(self, chunks):
        # Every miss is in the horizon by construction (the current window
        # is part of it), so admission is unconditional — the lookahead
        # knowledge pays on the EVICTION side, where it knows which
        # residents no in-flight window will touch again.
        return np.ones(chunks.shape[0], bool)

    def admit_order(self, chunks):
        return np.lexsort((chunks, -self.counts(chunks),
                           -self._hcounts(chunks)))

    def victim_order(self, chunks):
        # chunks the horizon never mentions go first (Belady: farthest —
        # here, never — next use), stalest-by-recency breaking ties
        return np.lexsort((chunks, self.lasts(chunks),
                           self._hcounts(chunks) > 0))

    def displace(self, cand, victims):
        n = min(cand.shape[0], victims.shape[0])
        cand, victims = cand[:n], victims[:n]
        # out-of-horizon victims yield unconditionally; in-horizon victims
        # only to a candidate the horizon wants strictly more (refusing
        # protects chunks a prefetched window is about to read)
        return ((self._hcounts(victims) == 0)
                | (self._hcounts(cand) > self._hcounts(victims)))


_POLICIES = {p.name: p for p in
             (FreqPolicy, LfuPolicy, LruPolicy, OraclePolicy)}


def make_cache_policy(policy: Optional[str] = None, *,
                      admit_threshold: int = 1) -> CachePolicy:
    """Resolve + instantiate (one policy instance per cache — the state is
    per-store, so sharded tiers build one per shard slice)."""
    return _POLICIES[resolve_cache_policy(policy)](admit_threshold)


__all__ = ["CACHE_POLICIES", "CachePolicy", "FreqPolicy", "LfuPolicy",
           "LruPolicy", "OraclePolicy", "make_cache_policy",
           "resolve_cache_policy"]
