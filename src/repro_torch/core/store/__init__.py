"""Embedding storage tiers behind one read surface (``repro.core.store``):
the device tier, the host-memory master (``HostStore``) and the chunked
device cache over it (``CachedStore``), its eviction policies, the
lookahead prefetcher, the async stage executor (``StageExecutor``,
``AsyncPrefetcher``) and the sparse-path wire policy (``SparseComm``:
``off``, ``pack``, ``int8``). The sharded tier is not ported yet
(``ROADMAP.md``, port Queue 1, item 6)."""
from .async_exec import AsyncPrefetcher, StageExecutor, resolve_async_stages
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
from .comm import PACK_PAD, SPARSE_COMMS, SparseComm, resolve_sparse_comm
from .device import DeviceStore
from .host import HostStore
from .policy import CACHE_POLICIES, CachePolicy, make_cache_policy, \
    resolve_cache_policy
from .prefetch import PrefetchEntry, Prefetcher

__all__ = [
    "AsyncPrefetcher",
    "StageExecutor",
    "resolve_async_stages",
    "PACK_PAD",
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
