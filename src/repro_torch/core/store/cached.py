"""CachedStore: a chunk-granular, policy-driven device cache of hot rows
over the host master (``repro.core.store.cached``).

A small hot set takes most accesses under zipf skew, so this tier keeps it
resident on the card and retrieval moves only the cold tail, in CHUNKS:
the cache is an array of ``cache_chunk_rows``-row chunks, the unit of
admission, eviction, directory state and host <-> device traffic.

  retrieve   hit rows come from the device cache and missed chunks from
             the host master, each missed chunk one contiguous slice
             staged to the card as one burst (``h2d_bursts``). The buffer
             is assembled on the card without copying the cache: one gather
             from the cache, one from the staged misses, and a select by
             the hit mask (the rows, then the adagrad state as an ``(n, 1)``
             view). The policy then admits missed chunks from the staged
             rows already on the card.
  commit     a write-back cache: rows whose chunk is resident are scattered
             into the cache in place; only host-resident rows are pulled
             back (compact, bucket-padded) and scattered into the master.
  eviction   whole chunks, the policy's victims outside the current window;
             each victim chunk is pulled and written back to the master in
             one burst (``d2h_bursts``).

Every device gather runs ``dispatch.gather_rows`` (the ``embedding_gather``
kernel on the card) and every cache write ``dispatch.scatter_rows``
(``embedding_scatter``). All of them run on the current stream in program
order, so the assembly reads the cache as it was before admission writes
it, and an eviction's pull is queued before the scatter that reuses its
slots. Host copies wait on the events of their own device work only.
Under the async stage executor the current stream is the executor's own,
shared by every worker and taken under the master lock, so the same order
holds across threads (``async_exec.py``). Under ``pack`` the staged index
vectors cross the bus in their narrow wire dtype and are cast to int32 on
the card before a kernel reads them; under ``int8`` the cold rows' commit
goes through ``SparseComm.writeback``, while eviction write-back and
``flush`` stay full precision in every mode.

Faults: the public stage methods and their retry seam are ``HostStore``'s.
The ``retrieve`` site fires at the entry of ``_retrieve_body``, ``h2d``
before the staging copy is queued, and so before the assembly reads the
cache and admission writes it; ``commit`` and ``d2h`` fire at the entry of
``_commit_body``, before the cache scatter. A replayed retrieve may count
the policy's touches, the horizon and hits and misses twice, as in JAX;
the values stay the fault-free run's.

The directory and the policy's state are chunk-keyed dicts (host memory
scales with the chunks a run touches). The cache decides only WHERE a
row's bytes live: training replays the host and device tiers bit for bit
under every policy. ``export_table`` writes the cache back first; cache
membership and policy state are not exported.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Union

import numpy as np
import torch

from ...kernels import dispatch
from ..embedding.engine import DualBuffer, EmbeddingEngine
from ..embedding.routing import SENTINEL
from ..embedding.table import EmbeddingTableState
from .base import FetchPlan
from .host import HostStore
from .policy import CachePolicy, make_cache_policy


def _pull(rows: torch.Tensor, accum: torch.Tensor, idx: torch.Tensor):
    """Compact device gather of rows and adagrad state at int32 ``idx``;
    an index past the end gives a zero row."""
    return (dispatch.gather_rows(rows, idx),
            dispatch.gather_rows(accum.view(-1, 1), idx).view(-1))


class CachedStore(HostStore):
    """Chunked device cache over the host master (see module docstring)."""

    tier = "cached"

    def __init__(
        self,
        engine: EmbeddingEngine,
        *,
        capacity: int = 0,
        admit_threshold: int = 1,
        miss_bucket: int = 64,
        chunk_rows: int = 8,
        policy: Union[str, CachePolicy, None] = None,
        horizon_windows: int = 2,
        **kwargs,
    ):
        spec = engine.spec
        if capacity <= 0:
            capacity = max(1024, spec.padded_rows // 8)
        self.chunk_rows = max(int(chunk_rows), 1)
        R = self.chunk_rows
        self.n_chunks_total = -(-spec.padded_rows // R)
        self.cap_chunks = int(min(max(-(-capacity // R), 1), self.n_chunks_total))
        self.capacity = self.cap_chunks * R  # cache rows actually allocated
        self.admit_threshold = max(int(admit_threshold), 1)
        self.miss_bucket = max(int(miss_bucket), 8)
        self._policy = (policy if isinstance(policy, CachePolicy)
                        else make_cache_policy(
                            policy, admit_threshold=self.admit_threshold))
        # host-authoritative chunk directory: a sparse dict one way, a
        # capacity-sized array the other (nothing scales with padded_rows)
        self._slot_of_chunk: Dict[int, int] = {}
        self._chunk_of_slot = np.full(self.cap_chunks, -1, np.int64)
        # rolling horizon: the chunk sets of the last ``horizon_windows``
        # retrieved windows (the prefetcher's in-flight union), published
        # to the policy on every retrieve
        self.horizon_windows = max(int(horizon_windows), 1)
        self._horizon: deque = deque()
        self.cache_rows: Optional[torch.Tensor] = None
        self.cache_accum: Optional[torch.Tensor] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0  # chunks evicted
        self.admissions = 0  # chunks admitted
        self.admission_skips = 0  # chunks barred by the admission block
        self.h2d_bursts = 0  # contiguous staged host -> device chunk reads
        self.d2h_bursts = 0  # contiguous device -> host chunk write-backs
        # chunks barred from admission for the next retrieve (the async
        # stage executor's hook) and the serving allow-list, which replaces
        # the policy's admission while set (see the setters)
        self._admission_block: Optional[np.ndarray] = None
        self._admission_allow: Optional[np.ndarray] = None
        super().__init__(engine, **kwargs)

    def _adopt(self, table: EmbeddingTableState) -> None:
        """A fresh host master, an empty cache, a cold policy."""
        super()._adopt(table)
        self.cache_rows = torch.zeros((self.capacity, self.spec.dim),
                                      dtype=self.rows.dtype, device=self.device)
        self.cache_accum = torch.zeros((self.capacity,), dtype=torch.float32,
                                       device=self.device)
        self._slot_of_chunk.clear()
        self._chunk_of_slot.fill(-1)
        self._horizon.clear()
        self._policy.reset()

    # -- chunk helpers ----------------------------------------------------

    def _chunk_slice_rows(self, chunks: np.ndarray) -> np.ndarray:
        """Master row ids covering ``chunks`` (chunk-major, R rows each);
        out-of-vocab tail positions come back as padded_rows."""
        R = self.chunk_rows
        ridx = (chunks[:, None] * R + np.arange(R, dtype=chunks.dtype)).reshape(-1)
        return np.minimum(ridx, self.spec.padded_rows)

    def _slots_of_chunks(self, chunks: np.ndarray) -> np.ndarray:
        get = self._slot_of_chunk.get
        return np.fromiter((get(c, -1) for c in chunks.tolist()),
                           np.int64, count=chunks.shape[0])

    def _push_horizon(self, u_chunks: np.ndarray) -> None:
        self._horizon.append(u_chunks)
        while len(self._horizon) > self.horizon_windows:
            self._horizon.popleft()
        counts: Dict[int, int] = {}
        for win in self._horizon:
            for c in win.tolist():
                counts[c] = counts.get(c, 0) + 1
        self._policy.set_horizon(counts)

    def _assemble(self, src: torch.Tensor, keys: torch.Tensor,
                  miss_rows: torch.Tensor, miss_accum: torch.Tensor) -> DualBuffer:
        """The buffer from the cache (``src < capacity``) and the staged
        misses (``src - capacity``); a sentinel's ``src`` is past both, a
        zero row. Picked by the hit mask, never added (``-0.0 + 0.0`` is
        ``+0.0``), so every row keeps its bits."""
        rows, accum = _pull(self.cache_rows, self.cache_accum, src)
        if miss_rows.shape[0]:
            msrc = src - self.capacity  # a hit's is negative: a zero row
            m_rows, m_accum = _pull(miss_rows, miss_accum, msrc)
            hit = src < self.capacity
            rows = torch.where(hit[:, None], rows, m_rows)
            accum = torch.where(hit, accum, m_accum)
        return DualBuffer(keys, rows, accum)

    # -- DBP stage 4a: cache-aware retrieval + admission -----------------

    def _retrieve_body(self, plan: FetchPlan) -> DualBuffer:
        self.faults.fire("retrieve")
        keys = plan.host_keys
        R = self.chunk_rows
        cap = self.capacity
        valid = keys != SENTINEL
        safe = np.where(valid, keys, 0)
        vkeys = safe[valid]
        vchunks = vkeys // R
        voffs = vkeys - vchunks * R
        u_chunks, inv, u_counts = np.unique(
            vchunks, return_inverse=True, return_counts=True)
        self._policy.touch(u_chunks, u_counts)
        self._push_horizon(u_chunks)
        u_slots = self._slots_of_chunks(u_chunks)
        slot_v = u_slots[inv]
        hit_v = slot_v >= 0
        miss_chunks = u_chunks[u_slots < 0]  # sorted unique
        nmc = int(miss_chunks.shape[0])
        # each missed chunk is ONE contiguous master slice: pad the burst
        # count, then stage pmc * R rows
        pmc = self.comm.pad_chunks(nmc, self.miss_bucket, R)
        pm = pmc * R

        stage_rows = self.copies.zeros((pm, self.spec.dim), self.rows.dtype)
        stage_accum = self.copies.zeros((pm,), torch.float32)
        if nmc:
            ridx = self._chunk_slice_rows(miss_chunks)
            ok = ridx < self.spec.padded_rows
            src_rows = torch.from_numpy(
                np.minimum(ridx, self.spec.padded_rows - 1).astype(np.int64))
            torch.index_select(self.rows, 0, src_rows, out=stage_rows[:nmc * R])
            torch.index_select(self.accum, 0, src_rows, out=stage_accum[:nmc * R])
            if not ok.all():  # zero the out-of-vocab tail of the last chunk
                tail = torch.from_numpy(~ok)
                stage_rows[:nmc * R][tail] = 0.0
                stage_accum[:nmc * R][tail] = 0.0

        # positions of the ACCESSED miss keys inside the staged burst
        j_v = np.searchsorted(miss_chunks, vchunks)
        miss_v = ~hit_v
        hot_idx = (j_v[miss_v] * R + voffs[miss_v]).astype(np.int64)
        self.h2d_bytes += self.comm.stage_chunk_payload(
            stage_rows, stage_accum, hot_idx)
        self.h2d_bursts += nmc

        src = np.full(keys.shape[0], cap + pm, np.int32)  # sentinel -> zero row
        src[valid] = np.where(hit_v, slot_v * R + voffs,
                              cap + j_v * R + voffs).astype(np.int32)
        src = self.comm.pack_index(src, cap + pm)  # the wire dtype under pack

        self.hits += int(hit_v.sum())
        self.misses += int(miss_v.sum())
        with self.stage_timers.timed("h2d_ms"):
            self.faults.fire("h2d")  # nothing of this stage is on the card yet
            stage_rows_d, stage_accum_d, src_d, keys_d = self.copies.to_device(
                stage_rows, stage_accum, self.copies.host(src),
                self.copies.host(keys.astype(np.int32)))
        src_d = src_d.to(torch.int32)
        # assemble BEFORE admission scatters: it reads the pre-admission
        # cache (program order on the stream)
        buf = self._assemble(src_d, keys_d, stage_rows_d, stage_accum_d)
        if nmc:
            self._admit_chunks(miss_chunks, vkeys[miss_v], j_v[miss_v],
                               u_chunks, stage_rows_d, stage_accum_d, pm)
        return buf

    def _admit_chunks(self, miss_chunks, miss_keys, miss_j, window_chunks,
                      stage_rows_d, stage_accum_d, pm: int) -> None:
        """Admit policy-approved missed chunks from their staged rows (no
        extra H2D): assign chunk slots (evicting if needed) and scatter the
        staged chunks into the device cache in place."""
        cap = self.capacity
        R = self.chunk_rows
        if self._admission_allow is not None:
            # serving allow-list: admit exactly the chunks with an accessed
            # key inside the visible horizon, no policy involved
            key_ok = np.isin(miss_keys, self._admission_allow)
            want = np.zeros(miss_chunks.shape[0], bool)
            np.logical_or.at(want, np.searchsorted(miss_chunks,
                                                   miss_keys // R), key_ok)
        else:
            want = self._policy.admit_mask(miss_chunks)
        if self._admission_block is not None and self._admission_block.size:
            blocked = np.unique(self._admission_block // R)
            fresh = ~np.isin(miss_chunks, blocked)
            self.admission_skips += int((want & ~fresh).sum())
            want &= fresh
        cand_pos = np.flatnonzero(want)
        if not cand_pos.size:
            return
        # most-deserving candidates first (policy order, deterministic)
        cand_pos = cand_pos[self._policy.admit_order(miss_chunks[cand_pos])]
        cand = miss_chunks[cand_pos]
        free = np.flatnonzero(self._chunk_of_slot < 0)
        n_free = min(free.size, cand_pos.size)
        admitted_pos = list(cand_pos[:n_free])
        admitted_slot = list(free[:n_free])
        if n_free:
            self._admit(cand[:n_free], free[:n_free])
        rest = cand_pos[n_free:]
        if rest.size:
            got = self._evict_for(miss_chunks[rest], window_chunks)
            n_evict = got.size
            if n_evict:
                self._admit(miss_chunks[rest[:n_evict]], got)
                admitted_pos.extend(rest[:n_evict])
                admitted_slot.extend(got)
        if not admitted_pos:
            return
        # staged chunk j occupies burst rows [j*R, (j+1)*R) (stage order)
        na = len(admitted_pos)
        self.admissions += na
        pac = self.comm.pad_chunks(na, self.miss_bucket, R)
        arange_r = np.arange(R, dtype=np.int64)
        idx = np.full(pac * R, pm, np.int32)  # pad -> zero rows
        idx[:na * R] = (np.asarray(admitted_pos, np.int64)[:, None] * R
                        + arange_r).reshape(-1)
        slots = np.full(pac * R, cap, np.int32)  # pad -> dropped
        slots[:na * R] = (np.asarray(admitted_slot, np.int64)[:, None] * R
                          + arange_r).reshape(-1)
        idx = self.comm.pack_index(idx, pm)
        slots = self.comm.pack_index(slots, cap)
        idx_d, slots_d = self.copies.to_device(self.copies.host(idx),
                                               self.copies.host(slots))
        rows_d, accum_d = _pull(stage_rows_d, stage_accum_d, idx_d.to(torch.int32))
        dispatch.scatter_rows(self.cache_rows, self.cache_accum,
                              slots_d.to(torch.int32), rows_d, accum_d)

    # -- DBP epilogue: split commit (cache scatter + compact D2H) --------

    def _commit_body(self, buffer: DualBuffer,
                     plan: Optional[FetchPlan] = None) -> None:
        # both sites precede the first mutation (the hot rows' scatter)
        self.faults.fire("commit")
        self.faults.fire("d2h")
        keys = plan.host_keys if plan is not None else buffer.keys.cpu().numpy()
        R = self.chunk_rows
        cap = self.capacity
        valid = keys != SENTINEL
        safe = np.where(valid, keys, 0)
        chunks = safe // R
        u_chunks, inv = np.unique(chunks, return_inverse=True)
        slot_k = self._slots_of_chunks(u_chunks)[inv]
        resident = valid & (slot_k >= 0)

        # ---- hot rows: in-place scatter into the device cache ----------
        upd_slots = np.where(resident, slot_k * R + (safe - chunks * R),
                             cap).astype(np.int32)
        (slots_d,) = self.copies.to_device(self.copies.host(upd_slots))
        dispatch.scatter_rows(self.cache_rows, self.cache_accum, slots_d,
                              buffer.rows.to(self.cache_rows.dtype), buffer.accum)

        # ---- cold rows: compact bucket-padded D2H + master scatter ------
        # (row-granular: updates exist only for accessed keys)
        host_pos = np.flatnonzero(valid & (slot_k < 0))
        nh = int(host_pos.size)
        if nh:
            k = buffer.rows.shape[0]
            idx = np.full(self.comm.pad_rows(nh, self.miss_bucket), k, np.int32)
            idx[:nh] = host_pos
            idx = self.comm.pack_index(idx, k)
            (idx_d,) = self.copies.to_device(self.copies.host(idx))
            rows, accum = self.copies.to_host(*_pull(buffer.rows, buffer.accum,
                                                     idx_d.to(torch.int32)))
            if self.comm.lossy:
                # int8: the cold rows are the infrequent set selective sync
                # targets; cache-resident rows moved no bytes above
                self.d2h_bytes += self.comm.writeback(
                    keys[host_pos], rows.numpy()[:nh], accum.numpy()[:nh],
                    self.rows.numpy(), self.accum.numpy())
            else:
                self.d2h_bytes += int(rows.nbytes) + int(accum.nbytes)
                cold = torch.from_numpy(keys[host_pos].astype(np.int64))
                self.rows.index_copy_(0, cold, rows[:nh])
                self.accum.index_copy_(0, cold, accum[:nh])

    def set_admission_block(self, keys: Optional[np.ndarray]) -> None:
        """Bar the chunks containing ``keys`` from admission for the next
        retrieve (the hook of the async stage executor, which holds back
        chunks with an unapplied commit)."""
        self._admission_block = keys

    def set_admission_allow(self, keys: Optional[np.ndarray]) -> None:
        """Admit a missed chunk iff one of its accessed keys is in ``keys``,
        the keys visible in the serving request queue (the serving view's
        ``set_read_horizon`` sets this before every coalesced retrieve).
        Replaces the policy's admission while set; ``None`` restores it.
        Eviction stays ranked by the policy, whose counts accrue on every
        retrieve here too."""
        self._admission_allow = keys

    def _admit(self, admit_chunks: np.ndarray, slot_ids: np.ndarray) -> None:
        for c, s in zip(admit_chunks.tolist(), slot_ids.tolist()):
            self._slot_of_chunk[c] = s
        self._chunk_of_slot[slot_ids] = admit_chunks

    def _evict_for(self, cand_chunks: np.ndarray,
                   window_chunks: np.ndarray) -> np.ndarray:
        """Evict the policy's coldest victim chunks outside the current
        window for candidates it lets displace them; write each victim back
        to the master. Returns the freed slot ids (aligned with
        ``cand_chunks``)."""
        occupied = np.flatnonzero(self._chunk_of_slot >= 0)
        if not occupied.size:
            return occupied
        ochunks = self._chunk_of_slot[occupied]
        # protect every chunk the current window touches, including the
        # chunks just admitted from its own miss burst
        out = ~np.isin(ochunks, window_chunks)
        evictable, vchunks = occupied[out], ochunks[out]
        if not evictable.size:
            return evictable
        order = self._policy.victim_order(vchunks)  # coldest first
        evictable, vchunks = evictable[order], vchunks[order]
        n = min(evictable.size, cand_chunks.size)
        take = self._policy.displace(cand_chunks[:n], vchunks[:n])
        n = int(take.sum()) if take.all() else int(np.argmin(take))
        if n <= 0:
            return evictable[:0]
        vslots, vchunks = evictable[:n], vchunks[:n]
        self._writeback_chunks(vslots, vchunks)
        for c in vchunks.tolist():
            del self._slot_of_chunk[c]
        self._chunk_of_slot[vslots] = -1
        self.evictions += n
        return vslots

    def _writeback_chunks(self, slots: np.ndarray, chunks: np.ndarray) -> None:
        """Pull ``slots``' chunks from the cache and write them into the
        host master, one burst each."""
        R = self.chunk_rows
        n = int(slots.shape[0])
        pvc = self.comm.pad_chunks(n, self.miss_bucket, R)
        arange_r = np.arange(R, dtype=np.int64)
        idx = np.full(pvc * R, self.capacity, np.int32)
        idx[:n * R] = (slots[:, None] * R + arange_r).reshape(-1)
        idx = self.comm.pack_index(idx, self.capacity)
        (idx_d,) = self.copies.to_device(self.copies.host(idx))
        rows, accum = self.copies.to_host(*_pull(self.cache_rows,
                                                 self.cache_accum,
                                                 idx_d.to(torch.int32)))
        self.d2h_bytes += int(rows.nbytes) + int(accum.nbytes)
        self.d2h_bursts += n
        ridx = self._chunk_slice_rows(chunks)
        ok = ridx < self.spec.padded_rows
        dst = torch.from_numpy(ridx[ok].astype(np.int64))
        if ok.all():
            rows, accum = rows[:n * R], accum[:n * R]
        else:
            sel = torch.from_numpy(np.flatnonzero(ok))
            rows, accum = rows.index_select(0, sel), accum.index_select(0, sel)
        self.rows.index_copy_(0, dst, rows)
        self.accum.index_copy_(0, dst, accum)

    # -- lifecycle -------------------------------------------------------

    def rows_used(self) -> int:
        """Real master rows now cache-resident (the tail chunk may cover
        fewer than ``chunk_rows``)."""
        R = self.chunk_rows
        pr = self.spec.padded_rows
        # a copy of the keys: a stage worker may admit while metrics read
        return sum(min(R, pr - c * R) for c in list(self._slot_of_chunk))

    def flush(self) -> None:
        """Refresh the host master from the cache (the cache stays valid)."""
        used = np.flatnonzero(self._chunk_of_slot >= 0)
        if used.size:
            self._writeback_chunks(used, self._chunk_of_slot[used])

    def export_table(self) -> EmbeddingTableState:
        """Master with the hot rows merged in; cache and policy state stay
        out of it (a new run starts cold)."""
        self.flush()
        return super().export_table()

    # -- metrics ---------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        out = super().metrics()
        out.update({
            "cache_hits": float(self.hits),
            "cache_misses": float(self.misses),
            "cache_evictions": float(self.evictions),
            "cache_admissions": float(self.admissions),
            "cache_admission_skips": float(self.admission_skips),
            "cache_rows_used": float(self.rows_used()),
            "cache_capacity": float(self.capacity),
            "cache_chunk_rows": float(self.chunk_rows),
            "cache_policy_chunks": float(self._policy.state_chunks()),
            "h2d_bursts": float(self.h2d_bursts),
            "d2h_bursts": float(self.d2h_bursts),
        })
        return out


__all__ = ["CachedStore"]
