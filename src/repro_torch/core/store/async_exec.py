"""Async host-stage executor: plan, retrieve and commit off the DBP
driver's critical path (``repro.core.store.async_exec``).

DBP's point (paper §IV) is that lookup-side work overlaps window compute.
With the synchronous :class:`~repro_torch.core.store.Prefetcher` the
driver thread still runs every host stage inline: the stage-3 key pull
and the host gather of ``retrieve`` come before the next window is
queued, and the host tiers' ``commit`` waits for its window, pulls the
buffer back and scatters it into the master. On a master in host memory
that host time is the cost nothing overlaps; this module moves it to
worker threads inside one process.

Threads
-------
``StageExecutor`` owns two pools:

* ``workers`` **stage threads** run plan + retrieve jobs (stages 3-4a);
* one **commit thread** applies commit jobs (the stage-6 epilogue)
  strictly in submission order. With ``workers=1`` the commits fold into
  the one stage thread: a FIFO that runs every host stage in submission
  order, the synchronous interleaving off the driver.

The driver thread only queues device work and pops finished jobs.

Exactness: the commit epoch fence
---------------------------------
The master has a monotone **commit epoch**: the number of commits applied.

1. **Retrieve fence.** A retrieve job computes ``fence = max(0, commits
   submitted before it - fence_slack)`` when it is submitted and waits,
   before it touches the master, until ``commit_epoch >= fence``. With
   ``fence_slack=0`` it replays the synchronous schedule's interleaving,
   and its critical path: nothing overlaps. A positive slack buys the
   overlap: the gather may read a master up to ``slack`` commits older
   than the synchronous schedule would.
2. **Epoch repair.** Each retrieve records the epoch its gather actually
   read (``read_epoch``, read under the master lock; ``>= fence``). Its
   buffer is stale by exactly the commits from ``read_epoch`` on, and each
   is repaired through the driver's ``sync_buffers`` intersection copy
   (Prop. 1, k deep): repairs for commits submitted before the window was
   issued come from the prefetcher's epoch-labelled ring of recent commit
   sources; those for commits submitted while it is in flight are applied
   at each commit once its job has finished, queued otherwise; ``pop``
   applies what is still queued, all in epoch order. In the caught-up
   steady state ``read_epoch`` equals the submission epoch and the
   schedule is the synchronous loop's one sync a step; only a lagging
   commit pipeline costs extra repairs. A repair against a commit the
   gather already saw is harmless: ``sync_buffers`` copies the updated
   rows verbatim, so an over-repair writes the same bytes, and rule 1
   rules out an under-repair. The async schedule is therefore bit for bit
   the synchronous loop, whatever the threads' timing.

The driver keeps ``fence_slack=0`` for the device tier (its stages are
device work, nothing to overlap on the host) and for the ``async``
staleness baseline (a relaxed fence would change which stale values it
reads).

The cached tier's admission copies a just-staged miss row into the device
cache, and that copy is never repaired. A row staged for a key of a
submitted but unapplied commit is stale, so the executor hands the keys
of unapplied commits to ``CachedStore.set_admission_block`` around every
retrieve: such chunks are admitted a window or two later, and every cached
row is exact at all times (placement may differ from the synchronous
schedule with more than one worker; values never do).

One ``lock`` serializes every master and cache-directory access: the
overlap is host work against device compute, never torn host state. With
``workers=1`` the cached tier's admission and frequency bookkeeping
replays in a fixed order; ``workers > 1`` keeps values exact, but cache
placement and the hit counters may vary from run to run.

Streams, and what PyTorch keeps per thread
------------------------------------------
JAX orders device work by data; the port orders it by CUDA streams, and
PyTorch keeps the current stream, the current device and grad mode per
thread. So:

* every job runs under ``torch.no_grad()``, on the store's device, with
  the executor's own **store stream** current. All device work a worker
  launches (the cached tier's assembly, admission and commit scatters and
  pulls; the device tier's gather and scatter) is on that one stream, in
  the order of launch under the master lock, so "commit ``e`` applied"
  means "ordered before every gather launched afterwards";
* routing stays on the driver thread (``store.route``), and the driver
  records an event after it; the worker's key pull waits for that event
  only, never for a window queued later;
* a retrieve records an event on the store stream when its buffer is
  made; the driver's stream waits on it, and takes the tensors over
  (``record_stream``), when the prefetcher realizes the entry;
* ``submit_commit`` records an event on the driver's stream right after
  the window's launches, and marks the window's buffer as used on the
  store stream; a host-tier commit job waits for that event on its thread
  before it takes the lock (JAX's ``block_until_ready``), the device tier
  makes the store stream wait on it;
* ``drain`` makes the driver's stream wait for the store stream, so the
  driver's ``release`` (the cached tier's flush) reads the committed cache.

Selection: ``NestPipeConfig.async_stages`` (``"auto"`` resolves
``$REPRO_ASYNC_STAGES``, then off), or ``DBPDriver(async_stages=...)``.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .prefetch import PrefetchEntry


def resolve_async_stages(value: Any = None) -> bool:
    """Resolve the async-stages switch: explicit arg > $REPRO_ASYNC_STAGES
    > off (``"auto"`` and None fall through)."""
    for cand in (value, os.environ.get("REPRO_ASYNC_STAGES")):
        if cand is None or cand == "auto":
            continue
        if isinstance(cand, bool):
            return cand
        s = str(cand).strip().lower()
        if s in ("1", "on", "true", "yes"):
            return True
        if s in ("0", "off", "false", "no"):
            return False
        raise ValueError(
            f"unknown async_stages value {cand!r}; expected "
            "'auto' | on | off (or a bool)")
    return False


class StageExecutor:
    """Worker threads for a store's host-side stages (module docstring).

    ``hooks`` is a test seam for a chosen interleaving: callables keyed by
    ``"retrieve_start" | "retrieve_done"`` (called with the window index on
    the stage thread) and ``"commit_submit" | "commit_apply"`` (called
    with the epoch on the driver and the commit thread). A hook that
    blocks forces a schedule, e.g. gating ``retrieve_start`` on a
    ``commit_submit`` runs the deferred epoch repair on demand.
    """

    def __init__(self, store, *, workers: int = 1, fence_slack: int = 0,
                 hooks: Optional[Dict[str, Callable]] = None):
        self.store = store
        self.fence_slack = max(int(fence_slack), 0)
        self.hooks = dict(hooks or {})
        self.lock = threading.Lock()  # master and cache-directory access
        self._epoch_cv = threading.Condition()
        self.commits_submitted = 0  # driver thread only
        self.commit_epoch = 0  # commits APPLIED (commit thread, under cv)
        self._stage_pool = ThreadPoolExecutor(
            max_workers=max(int(workers), 1), thread_name_prefix="repro-stage")
        # one worker: commits share its FIFO (module docstring); more: the
        # stage pool loses FIFO order, so commits get their own thread
        self._commit_pool = self._stage_pool if int(workers) <= 1 \
            else ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="repro-commit")
        self._commit_futures: List[Future] = []
        self._failed: Optional[BaseException] = None
        # epoch -> host keys of submitted but unapplied commits (the cached
        # tier must not admit their staged rows); its own small lock, since
        # a commit may hold the master lock for long
        self._pk_lock = threading.Lock()
        self._pending_commit_keys: Dict[int, Any] = {}
        # (stage, window, exc) of failed plan / retrieve jobs, in order:
        # AsyncPrefetcher.pop raises the first at once, labelled
        self._stage_failures: List[tuple] = []
        engine = getattr(store, "engine", None)
        device = getattr(engine, "device", None)
        if device is not None and device.type == "cuda":
            self.device = device
            self._driver_stream = torch.cuda.current_stream(device)
            self.stream = torch.cuda.Stream(device)
        else:
            self.device = self._driver_stream = self.stream = None

    def _hook(self, name: str, arg) -> None:
        fn = self.hooks.get(name)
        if fn is not None:
            fn(arg)

    def _record(self, stream) -> Optional[torch.cuda.Event]:
        if stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    @contextmanager
    def _on_worker(self):
        """What a job needs that PyTorch keeps per thread: no autograd, the
        store's device, and the store stream current."""
        with torch.no_grad():
            if self.device is None:
                yield
            else:
                with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                    yield

    # -- stages 3-4a: plan + retrieve ------------------------------------

    def submit_retrieve(self, keys, window: int) -> Future:
        """Issue plan + retrieve for one lookahead window on a stage thread.

        Resolves to ``(plan, buffer, read_epoch, ready)``: ``read_epoch`` is
        the commit epoch the gather read (every commit from it on must be
        repaired into the buffer), ``ready`` the store-stream event after
        the buffer (None on the CPU). Routing is queued here, on the
        driver thread, ahead of the next window; only the waits move to the
        worker: the key pull, the fence and the gather under the lock.
        """
        fence = max(self.commits_submitted - self.fence_slack, 0)
        wplan = self.store.route(keys)
        routed = self._record(self._driver_stream)

        def job():
            stage = "plan"
            try:
                with self._on_worker():
                    self._hook("retrieve_start", window)
                    plan = self.store.plan_from_window(wplan, after=routed)
                    stage = "fence"
                    with self._epoch_cv:
                        # a failed commit never bumps the epoch: wake up and
                        # raise instead of waiting forever
                        self._epoch_cv.wait_for(
                            lambda: self._failed is not None
                            or self.commit_epoch >= fence)
                        if self._failed is not None:
                            raise RuntimeError(
                                "commit stage failed; master state is undefined"
                            ) from self._failed
                    stage = "retrieve"
                    if routed is not None:
                        self.stream.wait_event(routed)  # the device tier reads the plan
                    block = getattr(self.store, "set_admission_block", None)
                    with self.lock:
                        # read under the master lock: exactly the epoch the
                        # gather sees, so only the commits it missed repair
                        read_epoch = self.commit_epoch
                        if block is not None:
                            block(self._blocked_keys())
                        try:
                            buffer = self.store.retrieve(plan)
                        finally:
                            if block is not None:
                                block(None)
                        ready = self._record(self.stream)
                    self._hook("retrieve_done", window)
                    return plan, buffer, read_epoch, ready
            except BaseException as e:
                # recorded for the eager raise at pop; the future keeps the
                # original exception
                with self._pk_lock:
                    self._stage_failures.append((stage, window, e))
                raise

        return self._stage_pool.submit(job)

    def adopt(self, buffer, ready: Optional[torch.cuda.Event]):
        """Hand a retrieved buffer to the driver's stream: it waits for the
        store stream's event, and the tensors are marked as used there."""
        if ready is not None:
            self._driver_stream.wait_event(ready)
            for t in buffer:
                t.record_stream(self._driver_stream)
        return buffer

    def first_stage_failure(self) -> Optional[tuple]:
        """The earliest failed plan / retrieve job as ``(stage, window,
        exc)``, or None."""
        with self._pk_lock:
            return self._stage_failures[0] if self._stage_failures else None

    def _blocked_keys(self):
        """Union key list of submitted but unapplied commits (called under
        the master lock, so the set cannot shrink during a retrieve)."""
        with self._pk_lock:
            pending = [k for k in self._pending_commit_keys.values()
                       if k is not None]
        if not pending:
            return None
        return pending[0] if len(pending) == 1 else np.concatenate(pending)

    # -- stage 6: the commit epilogue ------------------------------------

    def submit_commit(self, buffer, plan) -> Future:
        """Queue one window's commit. Commits apply strictly in submission
        order; each one bumps the epoch."""
        epoch = self.commits_submitted
        self.commits_submitted += 1
        with self._pk_lock:
            self._pending_commit_keys[epoch] = \
                getattr(plan, "host_keys", None) if plan is not None else None
        self._hook("commit_submit", epoch)
        # the window's launches are queued: mark them, and keep the buffer's
        # memory from reuse until the store stream's work on it is done
        ready = self._record(self._driver_stream)
        if ready is not None:
            for t in buffer:
                t.record_stream(self.stream)

        def job():
            try:
                with self._on_worker():
                    if ready is not None:
                        if self.store.tier != "device":
                            # the host needs the window's values: wait for
                            # them BEFORE the master lock, so fenced
                            # retrieves are not held for a window's length
                            ready.synchronize()
                        self.stream.wait_event(ready)
                    with self.lock:
                        self.store.commit(buffer, plan)
                        # cleared under the master lock: no retrieve sees
                        # this commit both applied and pending
                        with self._pk_lock:
                            self._pending_commit_keys.pop(epoch, None)
            except BaseException as e:
                with self._epoch_cv:
                    self._failed = e
                    self._epoch_cv.notify_all()
                raise
            with self._epoch_cv:
                self.commit_epoch = epoch + 1
                self._epoch_cv.notify_all()
            self._hook("commit_apply", epoch)

        fut = self._commit_pool.submit(job)
        self._commit_futures.append(fut)
        if len(self._commit_futures) >= 128:
            # keep the in-flight futures and any that carry an error
            self._commit_futures = [
                f for f in self._commit_futures
                if not f.done() or f.exception() is not None]
        return fut

    # -- lifecycle --------------------------------------------------------

    def drain(self) -> None:
        """Block until every submitted commit is applied, re-raising a
        worker's error here; then the driver's stream waits for the store
        stream. Call before ``export_table`` or ``release``."""
        futures, self._commit_futures = self._commit_futures, []
        for f in futures:
            f.result()
        if self.stream is not None:
            self._driver_stream.wait_stream(self.stream)

    def shutdown(self, wait: bool = True) -> None:
        self._stage_pool.shutdown(wait=wait)
        if self._commit_pool is not self._stage_pool:
            self._commit_pool.shutdown(wait=wait)


class _InFlight:
    """One lookahead window staged through the executor."""

    __slots__ = ("batch", "future", "window", "submit_epoch", "resolved",
                 "pending", "syncs_applied")

    def __init__(self, batch, future: Future, window: int, submit_epoch: int):
        self.batch = batch
        self.future = future
        self.window = window
        self.submit_epoch = submit_epoch  # commits submitted at issue time
        self.resolved = None  # (plan, buffer, read_epoch) once realized
        # sync sources of commits submitted while in flight, in epoch order
        self.pending: List[Any] = []
        self.syncs_applied = 0


class AsyncPrefetcher:
    """The executor's stand-in for :class:`~repro_torch.core.store.Prefetcher`.

    The same driver contract (``fill`` / ``pop`` / ``resync``), but
    ``fill`` only submits plan + retrieve jobs and ``pop`` resolves the
    window's future: the driver thread never runs a host gather.
    ``resync`` is the epoch repair: an entry whose retrieve is still in
    flight queues the sync source instead of syncing now, and ``pop``
    applies the queue in epoch order (module docstring, rule 2).
    """

    def __init__(self, next_batch: Callable[[], Any], store,
                 executor: StageExecutor, *, depth: int = 1,
                 keys_field: str = "keys", strict: bool = False):
        self.next_batch = next_batch
        self.store = store
        self.executor = executor
        self.depth = max(int(depth), 1)
        self.keys_field = keys_field
        self.strict = strict  # assert the epoch-repair invariant (nestpipe)
        self._q: "deque[_InFlight]" = deque()
        self._sync_fn: Optional[Callable] = None
        self._windows_issued = 0
        # epoch-labelled ring of recent commit sources: an entry resolving
        # late takes the repairs for commits before its issue from here.
        # The fence bounds read_epoch >= submit_epoch - fence_slack, and up
        # to ``depth`` more commits land while an entry is in flight.
        self._ring: "deque" = deque(maxlen=executor.fence_slack + self.depth)
        # syncs applied: at a commit to a realized buffer (what the
        # synchronous loop does), deferred from the in-flight queue, and
        # from the ring (commits the gather missed before its issue)
        self.repairs = {"at_commit": 0, "deferred": 0, "ring": 0}

    def __len__(self) -> int:
        return len(self._q)

    def fill(self, limit: Optional[int] = None) -> None:
        """Top up to ``depth`` in-flight windows (``limit`` caps the fill
        as in the synchronous Prefetcher)."""
        target = self.depth if limit is None else min(self.depth, max(limit, 0))
        while len(self._q) < target:
            batch = self.next_batch()
            fut = self.executor.submit_retrieve(
                batch[self.keys_field], self._windows_issued)
            self._q.append(_InFlight(batch, fut, self._windows_issued,
                                     self.executor.commits_submitted))
            self._windows_issued += 1

    def _realize(self, e: _InFlight) -> None:
        """Resolve the future, hand the buffer to the driver's stream, and
        repair it against the commits its gather missed (epochs from
        ``read_epoch``): ring sources for those before the entry was
        issued, then the in-flight queue, in epoch order."""
        plan, buffer, read_epoch, ready = e.future.result()
        buffer = self.executor.adopt(buffer, ready)
        for epoch, src in self._ring:
            if read_epoch <= epoch < e.submit_epoch:
                buffer = self._sync_fn(src, buffer)
                e.syncs_applied += 1
                self.repairs["ring"] += 1
        for epoch, src in e.pending:
            if epoch >= read_epoch:
                buffer = self._sync_fn(src, buffer)
                e.syncs_applied += 1
                self.repairs["deferred"] += 1
        e.pending.clear()
        e.resolved = (plan, buffer, read_epoch)

    def resync(self, buf_updated, sync_fn: Callable) -> None:
        """Epoch repair at one commit: sync the realized in-flight buffers
        now, queue the source for those still running, and keep it in the
        ring for entries that resolve later."""
        self._sync_fn = sync_fn
        self._ring.append((self.executor.commits_submitted, buf_updated))
        for e in self._q:
            if e.resolved is None and e.future.done():
                self._realize(e)
            if e.resolved is not None:
                plan, buffer, read_epoch = e.resolved
                e.resolved = (plan, sync_fn(buf_updated, buffer), read_epoch)
                e.syncs_applied += 1
                self.repairs["at_commit"] += 1
            else:
                e.pending.append((self.executor.commits_submitted, buf_updated))

    def pop(self) -> PrefetchEntry:
        failure = self.executor.first_stage_failure()
        if failure is not None:
            # raise a failed job at once, labelled: otherwise it would hide
            # behind ``depth`` healthy pops while the driver keeps committing
            stage, window, exc = failure
            raise RuntimeError(
                f"{stage} stage failed at window {window}") from exc
        if not self._q:
            self.fill(limit=1)
        e = self._q.popleft()
        if e.resolved is None:
            self._realize(e)  # re-raises a stage thread's error
        plan, buffer, read_epoch = e.resolved
        if self.strict:
            # rule 2: before this window's predecessor commits, the buffer
            # is repaired against exactly the commits its gather missed
            expected = self.executor.commits_submitted - read_epoch
            assert e.syncs_applied == expected, (
                e.window, e.syncs_applied, expected, read_epoch)
        return PrefetchEntry(e.batch, plan, buffer)


__all__ = [
    "AsyncPrefetcher",
    "StageExecutor",
    "resolve_async_stages",
]
