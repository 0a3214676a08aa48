"""Embedding storage tiers behind one read surface (``repro.core.store``):
the device tier, the host-memory master (``HostStore``) and the chunked
device cache over it (``CachedStore``), its eviction policies, the
lookahead prefetcher, and the sparse-path wire ledger in its ``off`` mode.
The async stage executor, the sharded tier and the ``pack`` / ``int8``
modes are not ported yet (``ROADMAP.md``, port Queue 1)."""
from .base import (
    STAGE_TIMER_KEYS,
    STORES,
    EmbeddingStore,
    FetchPlan,
    StageTimers,
    build_store,
    placeholder_table,
    resolve_store,
)
from .cached import CachedStore
from .comm import SPARSE_COMMS, SparseComm, resolve_sparse_comm
from .device import DeviceStore
from .host import HostStore
from .policy import CACHE_POLICIES, CachePolicy, make_cache_policy, \
    resolve_cache_policy
from .prefetch import PrefetchEntry, Prefetcher

__all__ = [
    "SPARSE_COMMS",
    "SparseComm",
    "resolve_sparse_comm",
    "CACHE_POLICIES",
    "CachePolicy",
    "make_cache_policy",
    "resolve_cache_policy",
    "STAGE_TIMER_KEYS",
    "STORES",
    "EmbeddingStore",
    "FetchPlan",
    "StageTimers",
    "build_store",
    "placeholder_table",
    "resolve_store",
    "CachedStore",
    "DeviceStore",
    "HostStore",
    "Prefetcher",
    "PrefetchEntry",
]
