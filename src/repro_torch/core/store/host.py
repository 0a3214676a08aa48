"""HostStore: the master table in host memory (``repro.core.store.host``).

Production recommendation tables outgrow device memory, so the master
lives in host DRAM and only the rows the in-flight windows need reach the
card: DBP stage 4a ("the retrieved embeddings are transferred from host
memory (DRAM) to device memory (HBM)"). The commit pulls the updated
compact buffer back and scatters it into the master.

The master is a CPU tensor (rows, plus the f32 rowwise-Adagrad ``accum``),
pinned when the compute device is CUDA so that copies run asynchronously;
on ``device="cpu"`` it is a plain CPU tensor (pinning needs a CUDA build).

Retrieval gathers with ``torch.index_select`` (multithreaded) into a fresh
staging tensor, zeroes the sentinel slots and copies it to the card with
``non_blocking=True`` on a side CUDA stream; the consuming stream waits on
the copy's event. Staging tensors are fresh on every call: PyTorch's
caching host allocator keeps a pinned block until the copies that read it
are done, which a buffer reused by hand would not be. On the CPU the staged
tensors are the buffer, so they are never views of the master, which the
commit mutates.

The commit copies the buffer to the host on the side stream after an event
that marks the window's update, waits for that copy's event alone, and
scatters the rows into the master at the unique valid keys.

Not ported yet: the async stage executor's staging pool and the fault
injection and retry seam (``ROADMAP.md``, port Queue 1, items 2 and 3).
The method split (``route`` / ``plan_from_window``, ``gather_host`` /
``scatter_host``, the ``_retrieve_body`` and ``_commit_body`` behind
``retrieve`` and ``commit``) is kept so that they can wrap it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..embedding.engine import DualBuffer, EmbeddingEngine
from ..embedding.routing import SENTINEL
from ..embedding.table import EmbeddingTableState
from .base import FetchPlan, StageTimers, placeholder_table
from .comm import SparseComm


class SideStreamCopies:
    """Host <-> device copies on a side CUDA stream, with their device time
    read from CUDA events (``h2d_copy_ms``, ``d2h_copy_ms``). On the CPU
    both directions hand the tensors back as they are."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.pinned else None
        self.ms = {"h2d_copy_ms": 0.0, "d2h_copy_ms": 0.0}
        self._open: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def host(self, array: np.ndarray) -> torch.Tensor:
        """A fresh host tensor of ``array`` (pinned on CUDA)."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        return t.pin_memory() if self.pinned else t.clone()

    def empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.pinned)

    def zeros(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self.pinned)

    def to_device(self, *host: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Copy ``host`` tensors to the card on the side stream; the current
        stream waits for them before its next work."""
        if self.stream is None:
            return host
        consumer = torch.cuda.current_stream(self.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(self.stream):
            start.record()
            out = tuple(t.to(self.device, non_blocking=True) for t in host)
            end.record()
        consumer.wait_event(end)
        for t in out:  # allocated on the side stream, used on the consumer
            t.record_stream(consumer)
        self._open.append((start, end))
        return out

    def to_host(self, *dev: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Copy ``dev`` tensors to fresh pinned host tensors on the side
        stream, after the work queued so far on the current stream; waits
        for that copy only."""
        if self.stream is None:
            return dev
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        self.stream.wait_event(ready)
        out = tuple(self.empty(t.shape, t.dtype) for t in dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(self.stream):
            start.record()
            for o, t in zip(out, dev):
                o.copy_(t, non_blocking=True)
            end.record()
        # ``dev`` was made on the current stream and stays referenced until
        # this returns, after the copy: no record_stream is needed
        end.synchronize()
        self.ms["d2h_copy_ms"] += start.elapsed_time(end)
        return out

    def times(self) -> Dict[str, float]:
        """Device ms of the copies so far (H2D copies still in flight are
        counted when they are done)."""
        still = []
        for start, end in self._open:
            if end.query():
                self.ms["h2d_copy_ms"] += start.elapsed_time(end)
            else:
                still.append((start, end))
        self._open = still
        return dict(self.ms)


class HostStore:
    """Host-memory master tier for one mega-table (see module docstring)."""

    tier = "host"

    def __init__(
        self,
        engine: EmbeddingEngine,
        *,
        n_micro: int = 1,
        comm: Optional[SparseComm] = None,
        table: Optional[EmbeddingTableState] = None,
    ):
        self.engine = engine
        self.spec = engine.spec
        self.device = engine.device
        self.n_micro = n_micro
        self.comm = comm if comm is not None else SparseComm()
        self.sparse_comm = self.comm.mode
        self.copies = SideStreamCopies(self.device)
        self.rows: Optional[torch.Tensor] = None
        self.accum: Optional[torch.Tensor] = None
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.owns_master = False
        self.stage_timers = StageTimers()
        if table is not None:
            self._adopt(table)

    @classmethod
    def from_device_table(cls, engine: EmbeddingEngine,
                          table: EmbeddingTableState, **kwargs) -> "HostStore":
        """A store whose master is a host copy of ``table`` (through
        ``__init__``, so a subclass comes back whole)."""
        return cls(engine, table=table, **kwargs)

    def _adopt(self, table: EmbeddingTableState) -> None:
        """Copy ``table`` into a fresh host master."""
        d = self.spec.dim
        if tuple(table.rows.shape) != (self.spec.padded_rows, d):
            raise ValueError(f"table shape {tuple(table.rows.shape)} != "
                             f"({self.spec.padded_rows}, {d})")
        self.rows = self.copies.empty(table.rows.shape, table.rows.dtype)
        self.rows.copy_(table.rows)
        self.accum = self.copies.empty(table.accum.shape, torch.float32)
        self.accum.copy_(table.accum)

    # -- lifecycle -------------------------------------------------------

    def ingest(self, table: EmbeddingTableState) -> EmbeddingTableState:
        self._adopt(table)
        self.owns_master = True
        return placeholder_table(table)

    def export_table(self) -> EmbeddingTableState:
        """The master on the compute device, as a SNAPSHOT: later commits
        never show through it."""
        return EmbeddingTableState(self.rows.to(self.device, copy=True),
                                   self.accum.to(self.device, copy=True))

    def release(self) -> EmbeddingTableState:
        table = self.export_table()
        self.owns_master = False
        return table

    # -- DBP stage 3: route + host key copy ------------------------------

    def route(self, keys):
        """Stage-3 routing of an (N, *batch) key window on the card."""
        with self.stage_timers.timed("plan_ms"):
            keys = torch.as_tensor(keys, dtype=torch.int32, device=self.device)
            return self.engine.route_window(keys, self.n_micro)

    def plan_from_window(self, window) -> FetchPlan:
        """Stage-3 host half: pull the owner-side union key list to the
        host, through the wire policy."""
        with self.stage_timers.timed("plan_ms"):
            host_keys = window.buffer_keys.cpu().numpy()
            return FetchPlan(window, self.comm.exchange_keys(host_keys))

    def plan(self, keys) -> FetchPlan:
        return self.plan_from_window(self.route(keys))

    # -- DBP stage 4a: host-side gather + H2D ----------------------------

    def gather_host(self, buffer_keys: np.ndarray):
        """Master rows and adagrad state for the (sorted, sentinel-padded)
        ``buffer_keys`` into fresh host tensors, sentinel slots zeroed. No
        device work, no counters."""
        k = buffer_keys.shape[0]
        rows = self.copies.empty((k, self.spec.dim), self.rows.dtype)
        accum = self.copies.empty((k,), torch.float32)
        valid = buffer_keys != SENTINEL
        idx = torch.from_numpy(np.where(valid, buffer_keys, 0).astype(np.int64))
        torch.index_select(self.rows, 0, idx, out=rows)
        torch.index_select(self.accum, 0, idx, out=accum)
        invalid = torch.from_numpy(~valid)
        rows[invalid] = 0
        accum[invalid] = 0
        return rows, accum

    def scatter_host(self, keys: np.ndarray, rows: torch.Tensor,
                     accum: torch.Tensor) -> None:
        """Write buffer rows and adagrad state into the master at the valid
        (unique) ``keys``; sentinel slots drop. No counters."""
        pos = np.flatnonzero(keys != SENTINEL)
        dst = torch.from_numpy(keys[pos].astype(np.int64))
        if pos.size and pos[-1] == pos.size - 1:  # the usual sentinel suffix
            rows, accum = rows[:pos.size], accum[:pos.size]
        else:
            sel = torch.from_numpy(pos)
            rows, accum = rows.index_select(0, sel), accum.index_select(0, sel)
        self.rows.index_copy_(0, dst, rows.to(self.rows.dtype))
        self.accum.index_copy_(0, dst, accum)

    def stage(self, buffer_keys: np.ndarray) -> DualBuffer:
        """Gather master rows for ``buffer_keys`` into fresh host tensors
        and stage them to the card as a new buffer."""
        rows, accum = self.gather_host(buffer_keys)
        self.h2d_bytes += self.comm.stage_payload(rows, accum)
        keys = self.copies.host(buffer_keys.astype(np.int32))
        with self.stage_timers.timed("h2d_ms"):
            return DualBuffer(*self.copies.to_device(keys, rows, accum))

    def retrieve(self, plan: FetchPlan) -> DualBuffer:
        with self.stage_timers.timed("retrieve_ms"):
            return self._retrieve_body(plan)

    def _retrieve_body(self, plan: FetchPlan) -> DualBuffer:
        return self.stage(plan.host_keys)

    # -- DBP epilogue: D2H + host scatter --------------------------------

    def commit(self, buffer: DualBuffer, plan: Optional[FetchPlan] = None) -> None:
        with self.stage_timers.timed("commit_ms"):
            self._commit_body(buffer, plan)

    def _commit_body(self, buffer: DualBuffer,
                     plan: Optional[FetchPlan]) -> None:
        keys = plan.host_keys if plan is not None else buffer.keys.cpu().numpy()
        rows, accum = self.copies.to_host(buffer.rows, buffer.accum)
        self.d2h_bytes += int(rows.nbytes) + int(accum.nbytes)
        self.scatter_host(keys, rows, accum)

    # -- metrics ---------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        out = {"h2d_bytes": float(self.h2d_bytes),
               "d2h_bytes": float(self.d2h_bytes),
               **self.comm.counters(),
               **self.stage_timers.as_dict()}
        if self.copies.stream is not None:
            out.update(self.copies.times())
        return out

    def memory_bytes(self) -> int:
        return int(self.rows.nbytes) + int(self.accum.nbytes)


__all__ = ["HostStore", "SideStreamCopies"]
