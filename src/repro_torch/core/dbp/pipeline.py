"""DBP host driver (paper §IV), ``repro.core.dbp.pipeline`` in PyTorch.

Orchestrates the inter-batch pipeline over a batch stream:

    stage 1  data prefetch   — PrefetchQueue thread (data/pipeline)
    stage 2  data H2D        — pinned, non-blocking copies (stage_to_device)
    stage 3  key routing     — store.plan
    stage 4  retrieval+sync  — store.retrieve into a fresh buffer (4a), then
                               the intersection sync against the window
                               just updated (4b, ``sync_buffers``)
    stage 5  fwd/bwd (FWP)   — the frozen window over N micro-batches
    stage 6  commit          — store.commit: the master write-back

A :class:`~repro_torch.core.store.Prefetcher` keeps ``lookahead`` batches
routed and retrieved ahead of the window, so their device work is queued
before the window's; every in-flight buffer is re-synced at every commit,
so lookahead never trades exactness.

With ``async_stages`` on (pipelined modes only), the host-side stages run
on worker threads: a :class:`~repro_torch.core.store.StageExecutor` runs
plan + retrieve and the commit, epoch-fenced, and an
:class:`~repro_torch.core.store.AsyncPrefetcher` repairs each buffer
against the commits its gather missed, so the trajectory stays the
synchronous loop's bit for bit (``core/store/async_exec.py``). The driver
only queues device work and pops finished jobs; it drains the commits
before the master is released.

Modes: ``nestpipe`` (the above), ``async`` (the same without the sync: the
staleness baseline) and ``serial`` (no pipelining: each micro-batch looks
up the master directly, one master update per step).

Hot-loop discipline: the loop never reads a device value per step. Each
step's aux dict stays on the device in a pending list and is drained
(one device sync, then host conversion) every ``metrics_every`` steps and
at the end of the run. On CUDA each step records an event when its work
is queued, and a step's time is the device-timeline span between two
steps' events (it includes any time the device sat idle waiting for the
host); on the CPU a drained span's host wall time is spread evenly over
its steps, as the JAX driver does.

The store is a seam: the device, host and cached tiers ride the same loop.
``run`` consumes its state: the master moves into the store at the start
(the state carries a zero-row placeholder) and comes back at the end, so
a host tier frees the device copy while it runs, as long as the caller
keeps no reference to it.

Checkpoints: every ``ckpt_every`` steps the driver drains the pending
metrics, exports the master from the store (under async stages after the
executor's commits are applied, under its master lock) and hands the state
to ``on_checkpoint(state, steps_done)``; then it re-marks the step clock,
so the save's seconds stay out of the next step's span.

Faults (``dist/fault.py``): a ``guard`` (``PreemptionGuard``) is polled at
every step boundary, never mid-step. Once it latched a notice, the loop
breaks after window t's commit was submitted (``preempted_at = t + 1``;
the last step is no preemption): under async stages the executor applies
every queued commit and its in-flight lookahead retrieves finish before
the store releases the master, and ``on_checkpoint(state,
preempted_at)`` then saves the released state. The master then holds
exactly ``t + 1`` whole windows and no lookahead buffer was committed, so
a run resumed from that save retrieves what the uninterrupted run's
repaired buffers held, and continues its trajectory bit for bit. A
``watchdog`` (``StepWatchdog``) owns straggler detection when given: the
metric drain hands it every step's time (on CUDA the step's own
device-timeline span, idle included, not a span average), and
``straggler_steps`` are its events. The host stores' retries and the
injected faults surface as ``stage_retries``, ``commit_rollbacks`` and
``faults_injected`` in ``summary()``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ...data.pipeline import PrefetchQueue, make_cluster_transform, stage_to_device
from ...train.state import PipelineCarry, TrainState
from ..store import STAGE_TIMER_KEYS, Prefetcher
from ..store.async_exec import AsyncPrefetcher, StageExecutor, resolve_async_stages

MODES = ("nestpipe", "async", "serial")


@dataclass
class PipelineStats:
    step_times: List[float] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    # an LM's MoE load-balance term a step (the micro-batches' mean; zeros
    # for a dense stack), where the loss reports one
    moe_aux: List[float] = field(default_factory=list)
    input_wait_times: List[float] = field(default_factory=list)
    input_wait_total: float = 0.0
    straggler_steps: List[int] = field(default_factory=list)
    overflow_max: int = 0
    store_tier: str = "device"
    sparse_comm: str = "off"
    async_stages: bool = False
    # the step boundary (1-based, of this run) where a preemption notice
    # stopped the loop; None for a run that went the distance
    preempted_at: Optional[int] = None
    # the executor's repairs by kind (AsyncPrefetcher.repairs), async only
    async_repairs: Dict[str, int] = field(default_factory=dict)
    # cumulative store counters at the last drain, and at the first drain
    # after a step (the end of warm-up: the first calls and a cold cache)
    store_metrics: Dict[str, float] = field(default_factory=dict)
    store_metrics_warm: Dict[str, float] = field(default_factory=dict)

    def add_input_wait(self, dt: float) -> None:
        self.input_wait_times.append(dt)
        self.input_wait_total += dt

    def _cache_rates(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        m = self.store_metrics
        if "cache_hits" in m:
            total = m["cache_hits"] + m["cache_misses"]
            if total:
                out["cache_hit_rate"] = m["cache_hits"] / total
            w = self.store_metrics_warm
            if w:
                dh = m["cache_hits"] - w.get("cache_hits", 0.0)
                dm = m["cache_misses"] - w.get("cache_misses", 0.0)
                if dh + dm > 0:
                    out["cache_hit_rate_steady"] = dh / (dh + dm)
        return out

    def summary(self) -> Dict[str, float]:
        st = np.asarray(self.step_times[1:] or self.step_times)
        out = {
            "steps": len(self.step_times),
            "mean_step_s": float(st.mean()) if len(st) else 0.0,
            "p50_step_s": float(np.percentile(st, 50)) if len(st) else 0.0,
            "p99_step_s": float(np.percentile(st, 99)) if len(st) else 0.0,
            "mean_input_wait_s": float(np.mean(self.input_wait_times or [0.0])),
            "stragglers": len(self.straggler_steps),
            "final_loss": self.losses[-1] if self.losses else float("nan"),
            "overflow_max": self.overflow_max,
            "store": self.store_tier,
            "sparse_comm": self.sparse_comm,
            "async_stages": self.async_stages,
            **{f"async_repairs_{k}": v for k, v in self.async_repairs.items()},
        }
        for k in ("h2d_bytes", "d2h_bytes", "h2d_bursts", "d2h_bursts",
                  "wire_bytes", "idx_bytes", "comm_rows_synced",
                  "comm_rows_deferred", "h2d_copy_ms", "d2h_copy_ms",
                  "stage_retries", "commit_rollbacks",
                  "faults_injected") + STAGE_TIMER_KEYS:
            if k in self.store_metrics:
                out[k] = self.store_metrics[k]
        out.update(self._cache_rates())
        if self.preempted_at is not None:
            out["preempted_at"] = self.preempted_at
        return out


class _MetricsDrain:
    """Deferred device->host metric conversion (see module docstring).

    ``push`` keeps a step's aux dict (and, on CUDA, the event recorded when
    the step's work was queued) pending; ``drain`` syncs once, converts the
    whole span, records step times and the straggler EMA (or hands each
    step's time to the ``watchdog``, which then owns straggler detection:
    its events and ``straggler_steps`` agree by construction), and
    snapshots the store's host-side counters.
    """

    def __init__(self, stats: PipelineStats, straggler_factor: float,
                 store=None, watchdog=None):
        self.stats = stats
        self.straggler_factor = straggler_factor
        self.store = store
        self.watchdog = watchdog
        self.pending: List[tuple] = []
        self.ema: Optional[float] = None
        self._t_mark = time.perf_counter()
        self._wait_mark = 0.0  # stats.input_wait_total at the mark
        self._event_mark: Optional[torch.cuda.Event] = None

    def start(self, device: torch.device) -> None:
        """Mark the start of the next span (an event on CUDA): the run's
        start, and again after work that is no step's, such as a save."""
        self._t_mark = time.perf_counter()
        self._wait_mark = self.stats.input_wait_total
        if device.type == "cuda":
            self._event_mark = torch.cuda.Event(enable_timing=True)
            self._event_mark.record()

    def push(self, t: int, aux, event: Optional[torch.cuda.Event] = None) -> None:
        self.pending.append((t, aux, event))

    def _span_times(self, now: float) -> List[float]:
        events = [e for _, _, e in self.pending]
        if self._event_mark is not None and all(e is not None for e in events):
            events[-1].synchronize()
            marks = [self._event_mark] + events
            self._event_mark = events[-1]
            return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        waited = self.stats.input_wait_total - self._wait_mark
        dt = max(now - self._t_mark - waited, 0.0) / len(self.pending)
        return [dt] * len(self.pending)

    def drain(self) -> None:
        if self.pending:
            losses = torch.stack([aux["loss"] for _, aux, _ in self.pending]).tolist()
            if all("moe_aux" in aux for _, aux, _ in self.pending):
                self.stats.moe_aux.extend(
                    torch.stack([aux["moe_aux"] for _, aux, _ in self.pending]).tolist())
            ovf = [aux["routing_overflow"] for _, aux, _ in self.pending
                   if "routing_overflow" in aux]
            if ovf:
                self.stats.overflow_max = max(self.stats.overflow_max,
                                              int(torch.stack(ovf).max()))
            now = time.perf_counter()
            for (t, _, _), dt, loss in zip(self.pending, self._span_times(now),
                                           losses):
                self.stats.step_times.append(dt)
                self.stats.losses.append(loss)
                if self.watchdog is not None:
                    if self.watchdog.observe(t, dt):
                        self.stats.straggler_steps.append(t)
                    continue
                if self.ema is not None and dt > self.straggler_factor * self.ema:
                    self.stats.straggler_steps.append(t)
                self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
            self.pending.clear()
        self._t_mark = time.perf_counter()
        self._wait_mark = self.stats.input_wait_total
        if self.store is not None:
            self.stats.store_metrics = dict(self.store.metrics())
            if not self.stats.store_metrics_warm and self.stats.step_times:
                self.stats.store_metrics_warm = dict(self.stats.store_metrics)


class DBPDriver:
    """Runs NestPipe training (or a baseline mode) over a host batch stream."""

    def __init__(
        self,
        step_fns,  # train.step.StepFns
        source: Iterator,  # yields dict batches with a "keys" field (numpy)
        n_micro: int,
        *,
        store,  # a core.store tier over the workload's engine
        mode: str = "nestpipe",  # "nestpipe" | "async" | "serial"
        clustering: str = "keycentric",
        device_fields: Optional[List[str]] = None,  # batch fields shipped to device
        straggler_factor: float = 3.0,
        metrics_every: int = 8,  # steps between deferred metric drains
        lookahead: int = 1,  # DBP retrieval lookahead depth k (Prefetcher)
        async_stages="auto",  # host stages on worker threads ("auto" ->
        # $REPRO_ASYNC_STAGES -> off); serial mode ignores it
        stage_workers: int = 1,  # plan / retrieve threads (>1: values exact,
        # cache placement and counters may vary from run to run)
        stage_hooks=None,  # StageExecutor test seam (schedule injection)
        on_checkpoint=None,  # (state with the master, steps done) -> None
        ckpt_every: int = 0,  # steps between checkpoints (0: none)
        guard=None,  # dist.fault.PreemptionGuard, polled at step boundaries
        watchdog=None,  # dist.fault.StepWatchdog: owns straggler detection
    ):
        if mode not in MODES:
            raise ValueError(f"unknown driver mode {mode!r}; expected one of {MODES}")
        if mode == "serial" and store.tier != "device":
            raise ValueError(
                "serial mode is the TorchRec-like device-resident baseline; "
                f"store={store.tier!r} requires a pipelined mode (nestpipe | async)")
        self.fns = step_fns
        self.n_micro = n_micro
        self.mode = mode
        self.store = store
        self.device = store.engine.device
        self.device_fields = device_fields
        self.straggler_factor = straggler_factor
        self.metrics_every = max(int(metrics_every), 1)
        self.lookahead = max(int(lookahead), 1)
        self.async_stages = resolve_async_stages(async_stages) and mode != "serial"
        self.stage_workers = max(int(stage_workers), 1)
        # commits a retrieve may trail: overlap needs a relaxed fence; the
        # device tier and the staleness baseline keep the synchronous
        # interleaving
        self.fence_slack = self.lookahead + 1 \
            if (mode == "nestpipe" and store.tier != "device") else 0
        self.stage_hooks = stage_hooks
        self.on_checkpoint = on_checkpoint
        self.ckpt_every = max(int(ckpt_every), 0)
        self.guard = guard
        self.watchdog = watchdog
        self._exec: Optional[StageExecutor] = None  # live only inside run()
        # Key-centric clustering only shapes FWP micro-batch locality; the
        # serial baseline has no window to cluster for.
        self.clustering = clustering if mode != "serial" else "none"
        transform = make_cluster_transform(n_micro, self.clustering)
        self.queue = PrefetchQueue(source, depth=2, transform=transform)

    # -- stages 1-2 -----------------------------------------------------

    def _next_device_batch(self, stats: PipelineStats):
        t0 = time.perf_counter()
        host_batch = self.queue.get()
        stats.add_input_wait(time.perf_counter() - t0)
        if self.device_fields is not None:
            host_batch = {k: host_batch[k] for k in self.device_fields}
        return stage_to_device(host_batch, self.device)

    def _step_event(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    # -- main loop --------------------------------------------------------

    def run(self, state: TrainState, num_steps: int):
        """Train ``num_steps`` steps from ``state``, which the run consumes
        (see the module docstring); returns ``(state, stats)``."""
        stats = PipelineStats(store_tier=self.store.tier,
                              sparse_comm=self.store.sparse_comm)
        drain = _MetricsDrain(stats, self.straggler_factor, store=self.store,
                              watchdog=self.watchdog)
        try:
            with torch.no_grad():
                drain.start(self.device)
                if self.mode == "serial":
                    return self._run_serial(state, num_steps, stats, drain)
                if num_steps <= 0:
                    return state, stats
                # the master moves into the store; the old state's table
                # goes with this rebinding
                state = state._replace(table=self.store.ingest(state.table))
                return self._run_pipelined(state, num_steps, stats, drain)
        finally:
            if self._exec is not None:
                self._exec.shutdown()
                self._exec = None
            self.queue.close()

    def _run_serial(self, state, num_steps, stats, drain):
        for t in range(num_steps):
            batch = self._next_device_batch(stats)
            state, aux, pkts = self.fns.serial_step_noupd(state, batch)
            state = state._replace(table=self.fns.commit_packets(state.table, pkts))
            drain.push(t, aux, self._step_event())
            self._maybe_drain(drain, t, num_steps)
            self._maybe_ckpt(state, t, drain)
            if self._preempt(t, num_steps):
                stats.preempted_at = t + 1
                break
        drain.drain()
        if stats.preempted_at is not None and self.on_checkpoint is not None:
            self.on_checkpoint(self._ckpt_state(state), stats.preempted_at)
        return state, stats

    def _run_pipelined(self, state, num_steps, stats, drain):
        sync_on = self.mode == "nestpipe"
        next_batch = lambda: self._next_device_batch(stats)  # noqa: E731
        if self.async_stages:
            stats.async_stages = True
            self._exec = StageExecutor(self.store, workers=self.stage_workers,
                                       fence_slack=self.fence_slack,
                                       hooks=self.stage_hooks)
            pf = AsyncPrefetcher(next_batch, self.store, self._exec,
                                 depth=self.lookahead, strict=sync_on)
            commit = self._exec.submit_commit
        else:
            pf = Prefetcher(next_batch, self.store, depth=self.lookahead)
            commit = self.store.commit
        pf.fill(limit=num_steps)  # windows 0..min(k, steps)-1
        first = pf.pop()  # warm-up: route + retrieve batch 0
        carry = PipelineCarry(first.buffer, first.plan.window)
        cur_plan, batch = first.plan, first.batch
        for t in range(num_steps):
            # stages 3+4 for t+1..t+k are queued ahead of this window
            pf.fill(limit=num_steps - 1 - t)
            state, aux, buf_updated = self.fns.window_step(
                state, carry.buffer, carry.plan, batch)
            if t + 1 < num_steps:
                nxt = pf.pop()
                if sync_on:
                    # stage 4b: repair the t+1 buffer (and every deeper
                    # in-flight buffer) against this window's updates
                    nxt_buf = self.fns.sync_buffers(buf_updated, nxt.buffer)
                    pf.resync(buf_updated, self.fns.sync_buffers)
                else:
                    nxt_buf = nxt.buffer  # staleness baseline: no sync
            commit(buf_updated, cur_plan)  # stage 6 (inline or queued)
            if t + 1 < num_steps:
                carry = PipelineCarry(nxt_buf, nxt.plan.window)
                cur_plan, batch = nxt.plan, nxt.batch
            drain.push(t, aux, self._step_event())
            self._maybe_drain(drain, t, num_steps)
            self._maybe_ckpt(state, t, drain)
            if self._preempt(t, num_steps):
                # after window t's commit was submitted: the master holds
                # t + 1 whole windows once the executor drains, and no
                # lookahead buffer was committed (module docstring)
                stats.preempted_at = t + 1
                break
        if self._exec is not None:
            self._exec.drain()  # every commit applied: the master is final
            stats.async_repairs = dict(pf.repairs)
            if stats.preempted_at is not None:
                # the in-flight lookahead retrieves take the master lock:
                # they finish before the release (their fences name only
                # commits already applied, so none waits)
                self._exec.shutdown(wait=True)
        drain.drain()
        state = state._replace(table=self.store.release())
        if stats.preempted_at is not None and self.on_checkpoint is not None:
            self.on_checkpoint(state, stats.preempted_at)
        return state, stats

    def _preempt(self, t: int, num_steps: int) -> bool:
        """A notice latched and steps are left: the last step ends the run
        anyway and is no preemption."""
        return (self.guard is not None and self.guard.should_checkpoint
                and t + 1 < num_steps)

    def _maybe_drain(self, drain: _MetricsDrain, t: int, num_steps: int):
        # step 0 carries the first calls' set-up: drain it alone so it stays
        # out of the steady-state span (summary() drops step 0)
        if t == 0 or (t + 1) % self.metrics_every == 0 or t == num_steps - 1:
            drain.drain()

    def _ckpt_state(self, state: TrainState) -> TrainState:
        """``state`` with the master exported from the store."""
        if not self.store.owns_master:
            return state
        if self._exec is None:
            return state._replace(table=self.store.export_table())
        # every queued commit reaches the master first (and the driver's
        # stream waits for the executor's); the lock keeps retrieves out
        # while the cached tier's export flushes its hot rows
        self._exec.drain()
        with self._exec.lock:
            return state._replace(table=self.store.export_table())

    def _maybe_ckpt(self, state, t: int, drain: _MetricsDrain) -> None:
        if self.on_checkpoint is None or not self.ckpt_every \
                or (t + 1) % self.ckpt_every:
            return
        drain.drain()  # the steps so far are timed before the save
        self.on_checkpoint(self._ckpt_state(state), t + 1)
        drain.start(self.device)  # the save is no step's: a fresh mark
