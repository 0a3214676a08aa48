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
the copy's event. Staging tensors are fresh on every call, also on the
async executor's workers: PyTorch's caching host allocator keeps a pinned
block until the copies that read it are done and then reuses it, which a
buffer reused by hand would not be. On the CPU the staged tensors are the
buffer, so they are never views of the master, which the
commit mutates.

The commit copies the buffer to the host on the side stream after an event
that marks the window's update, waits for that copy's event alone, and
scatters the rows into the master at the unique valid keys; under the
``int8`` sparse-comm mode it applies the quantized deltas of the rows it
selects (``SparseComm.writeback``) instead.

The stage-3 key pull (``plan_from_window``) copies the window's key list
to a pinned tensor on the side stream after an event recorded when the
routing was queued (``after``; the async stage executor records it on the
driver thread), so it waits for the routing and not for later windows.

Under the async stage executor (``async_exec.py``) these methods run on
worker threads, with the executor's stream current: every copy's consumer
is then that stream, not the driver's.

Faults: ``plan_from_window``, ``retrieve`` and ``commit`` replay their
bodies (``_plan_body``, ``_retrieve_body``, ``_commit_body``) through
``retry_step`` (``dist/fault.py``), counted as ``stage_retries`` and
``commit_rollbacks``. The injector (``dist/inject.py``) fires its sites
``plan``, ``retrieve`` and ``commit`` at the entry of each body, ``h2d``
before the staging copy is queued and ``d2h`` before the commit's pull:
each before the stage's first master mutation and its first CUDA work, so
a replay repeats host work only (no side-stream copy or event is left
open) and the recovered run keeps the fault-free run's bits; only traffic
counters (``h2d_bytes``) may count a replayed stage twice, as in JAX. A
CUDA error (``torch.AcceleratorError``, ``torch.OutOfMemoryError``) is
sticky, not transient: it is raised at once, never replayed.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...dist.fault import retry_step
from ...dist.inject import NULL_INJECTOR, FaultInjector
from ..embedding.engine import DualBuffer, EmbeddingEngine
from ..embedding.routing import SENTINEL
from ..embedding.table import EmbeddingTableState
from .base import FetchPlan, StageTimers, placeholder_table
from .comm import SparseComm

# a CUDA error leaves the context broken: replaying the stage would only
# sleep and queue more work on it
_NOT_TRANSIENT = (torch.AcceleratorError, torch.OutOfMemoryError)


class SideStreamCopies:
    """Host <-> device copies on a side CUDA stream, with their device time
    read from CUDA events (``h2d_copy_ms``, ``d2h_copy_ms``). On the CPU
    both directions hand the tensors back as they are. Safe for the async
    executor's threads: the open events and the times take a lock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.pinned else None
        self._lock = threading.Lock()
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
        with self._lock:
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
        with self._lock:
            self.ms["d2h_copy_ms"] += start.elapsed_time(end)
        return out

    def keys_to_host(self, keys: torch.Tensor,
                     after: Optional[torch.cuda.Event]) -> np.ndarray:
        """``keys`` on the host, copied on the side stream after ``after``
        (default: an event recorded now on the current stream), waiting for
        that copy only. Not timed: it is the stage-3 pull, not staging."""
        if self.stream is None:
            return keys.cpu().numpy()
        if after is None:
            after = torch.cuda.Event()
            after.record(torch.cuda.current_stream(self.device))
        out = self.empty(keys.shape, keys.dtype)
        self.stream.wait_event(after)
        with torch.cuda.stream(self.stream):
            out.copy_(keys, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
        return out.numpy()

    def times(self) -> Dict[str, float]:
        """Device ms of the copies so far (H2D copies still in flight are
        counted when they are done)."""
        with self._lock:
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
        injector: Optional[FaultInjector] = None,
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
        # the chaos seam and the recovery budget (module docstring)
        self.faults = injector if injector is not None else NULL_INJECTOR
        self.retry_budget = 3
        self.retry_backoff_s = 0.05
        self.stage_retries = 0
        self.commit_rollbacks = 0
        self._retry_lock = threading.Lock()  # plans retry on several workers
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

    def plan_from_window(self, window, after=None) -> FetchPlan:
        """Stage-3 host half: pull the owner-side union key list to the
        host after the event ``after`` (default: now), through the wire
        policy."""
        with self.stage_timers.timed("plan_ms"):
            return self._recover("plan", self._plan_body, window, after)

    def _plan_body(self, window, after) -> FetchPlan:
        self.faults.fire("plan")
        host_keys = self.copies.keys_to_host(window.buffer_keys, after)
        return FetchPlan(window, self.comm.exchange_keys(host_keys))

    def plan(self, keys) -> FetchPlan:
        return self.plan_from_window(self.route(keys))

    # -- transient-fault recovery ----------------------------------------

    def _recover(self, stage: str, fn, *args):
        """Replay a stage body through ``retry_step`` (capped exponential
        backoff with jitter) and count the recoveries. The synchronous
        prefetcher and the async executor's workers call the same public
        stage methods, so one seam serves both; under the executor a
        commit's backoff holds the master lock, which is why the base is
        small. A CUDA error is raised unretried."""
        def note(attempt, exc):
            if isinstance(exc, _NOT_TRANSIENT):
                raise exc
            with self._retry_lock:
                if stage == "commit":
                    self.commit_rollbacks += 1
                else:
                    self.stage_retries += 1
        return retry_step(fn, *args, retries=self.retry_budget,
                          backoff_s=self.retry_backoff_s, on_retry=note)

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
        and stage them to the card as a new buffer; under int8 the staged
        rows quantize in place first."""
        rows, accum = self.gather_host(buffer_keys)
        self.h2d_bytes += self.comm.stage_payload(rows, accum)
        keys = self.copies.host(buffer_keys.astype(np.int32))
        with self.stage_timers.timed("h2d_ms"):
            # before the copy is queued: a replay leaves no open event
            self.faults.fire("h2d")
            return DualBuffer(*self.copies.to_device(keys, rows, accum))

    def retrieve(self, plan: FetchPlan) -> DualBuffer:
        with self.stage_timers.timed("retrieve_ms"):
            return self._recover("retrieve", self._retrieve_body, plan)

    def _retrieve_body(self, plan: FetchPlan) -> DualBuffer:
        self.faults.fire("retrieve")
        return self.stage(plan.host_keys)

    # -- DBP epilogue: D2H + host scatter --------------------------------

    def commit(self, buffer: DualBuffer, plan: Optional[FetchPlan] = None) -> None:
        with self.stage_timers.timed("commit_ms"):
            self._recover("commit", self._commit_body, buffer, plan)

    def _commit_body(self, buffer: DualBuffer,
                     plan: Optional[FetchPlan]) -> None:
        # both sites fire before the pull and the master's first mutation:
        # a rolled-back commit replays whole
        self.faults.fire("commit")
        keys = plan.host_keys if plan is not None else buffer.keys.cpu().numpy()
        self.faults.fire("d2h")
        rows, accum = self.copies.to_host(buffer.rows, buffer.accum)
        if self.comm.lossy:
            # int8: selective sync of quantized deltas with error feedback,
            # into the master's numpy views
            valid = keys != SENTINEL
            self.d2h_bytes += self.comm.writeback(
                keys[valid], rows.numpy()[valid], accum.numpy()[valid],
                self.rows.numpy(), self.accum.numpy())
        else:
            self.d2h_bytes += int(rows.nbytes) + int(accum.nbytes)
            self.scatter_host(keys, rows, accum)

    # -- metrics ---------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        out = {"h2d_bytes": float(self.h2d_bytes),
               "d2h_bytes": float(self.d2h_bytes),
               "stage_retries": float(self.stage_retries),
               "commit_rollbacks": float(self.commit_rollbacks),
               **self.faults.counters(),
               **self.comm.counters(),
               **self.stage_timers.as_dict()}
        if self.copies.stream is not None:
            out.update(self.copies.times())
        return out

    def memory_bytes(self) -> int:
        return int(self.rows.nbytes) + int(self.accum.nbytes)


__all__ = ["HostStore", "SideStreamCopies"]
