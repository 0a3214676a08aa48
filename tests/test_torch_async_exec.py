"""The port's async host-stage executor (``repro_torch.core.store
.async_exec``) against the port's own synchronous loop, case for case with
``tests/test_async_exec.py`` (its checkpoint case,
``test_checkpoint_export_drains_pending_commits``, is in
``tests/test_torch_checkpoint.py``).

Workload: the reduced ``dlrm-ctr`` (``global_batch=32``, N = 4,
``bucket_slack=4.0``), 5 steps (7 for the forced race), on the CPU.

Every comparison here is bit for bit (``==`` on the loss lists,
``torch.equal`` on the master rows and adagrad state): the executor moves
where the host stages run, never what they compute. The schedule sweep
over a pure-Python store compares exact float64 sums. The executor holds
no JAX code to compare with: ``tests/test_torch_store.py`` already holds
the port's synchronous tiers to the JAX package's within 1e-5, and
``tests/test_torch_sparse_comm.py`` does so with the executor on.
"""
import os
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _hypothesis_compat import given, settings, st

from repro_torch.api import Session, resolve_stream
from repro_torch.core.embedding.engine import DualBuffer
from repro_torch.core.embedding.routing import SENTINEL
from repro_torch.core.store import (
    AsyncPrefetcher,
    FetchPlan,
    HostStore,
    Prefetcher,
    StageExecutor,
    resolve_async_stages,
)
from repro_torch.train import clone_state

ARCH = "dlrm-ctr"
KW = dict(reduced=True, global_batch=32, n_micro=4, device="cpu")
STEPS = 5
TIERS = ("device", "host", "cached")


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for var in ("REPRO_STORE", "REPRO_CACHE_POLICY", "REPRO_SPARSE_COMM",
                "REPRO_ASYNC_STAGES"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def init_state():
    return clone_state(Session.from_arch(ARCH, **KW).state)


def run_tier(init, tier, *, steps=STEPS, async_on=False, lookahead=1,
             mode="nestpipe", workers=1, hooks=None, **sess_kw):
    """``steps`` steps through ``tier`` from ``init``; returns (state,
    stats, store)."""
    sess = Session.from_arch(ARCH, mode=mode, store=tier,
                             prefetch_ahead=lookahead, **KW, **sess_kw)
    sess.state = clone_state(init)
    driver_kw = {"async_stages": async_on}
    if async_on:
        driver_kw.update(stage_workers=workers, stage_hooks=hooks)
    driver = sess.strategy.build_driver(
        sess.fns, resolve_stream(sess.workload, sess.seed), sess.workload,
        **driver_kw)
    state, stats = driver.run(sess._take_state(), steps)
    return state, stats, driver.store


def _same(a, b):
    return torch.equal(a.table.rows, b.table.rows) and \
        torch.equal(a.table.accum, b.table.accum)


# ---------------------------------------------------------------------------
# the invariant: async stages replay the sync loop bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lookahead", [1, 3])
def test_async_stages_bit_exact_every_tier(init_state, lookahead):
    """Losses and the whole master, bit for bit, with the executor on, on
    all three tiers at lookahead 1 and 3, against the sync device tier."""
    ref_state, ref_stats, _ = run_tier(init_state, "device")
    for tier in TIERS:
        state, stats, _ = run_tier(init_state, tier, async_on=True,
                                   lookahead=lookahead)
        assert stats.losses == ref_stats.losses, tier
        assert _same(state, ref_state), tier
        assert stats.async_stages and stats.summary()["async_stages"] is True


def test_async_stages_matches_sync_traffic(init_state):
    """The same windows staged and commits applied: the byte counters of
    the drained run equal the synchronous loop's (exact)."""
    _, _, st_sync = run_tier(init_state, "host")
    _, _, st_async = run_tier(init_state, "host", async_on=True)
    assert st_async.h2d_bytes == st_sync.h2d_bytes
    assert st_async.d2h_bytes == st_sync.d2h_bytes


def test_staleness_baseline_rides_the_executor(init_state):
    """``mode="async"`` (no dual-buffer sync) gives the same stale
    trajectory through the executor as without it, bit for bit."""
    for tier in TIERS:
        _, stats_sync, _ = run_tier(init_state, tier, mode="async")
        _, stats_exec, _ = run_tier(init_state, tier, mode="async",
                                    async_on=True)
        assert stats_exec.losses == stats_sync.losses, tier


def test_multi_worker_stage_pool_stays_value_exact(init_state):
    """Two stage workers (retrieves may run out of order, commits on their
    own thread) keep values exact on the host tier, bit for bit."""
    ref_state, ref_stats, _ = run_tier(init_state, "device")
    state, stats, _ = run_tier(init_state, "host", async_on=True, lookahead=3,
                               workers=2)
    assert stats.losses == ref_stats.losses
    assert _same(state, ref_state)


# ---------------------------------------------------------------------------
# the commit-vs-retrieve race, scheduled on purpose
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["host", "cached"])
def test_deferred_epoch_repair_under_forced_race(init_state, tier):
    """Window 5's retrieve is gated until commit 3 is SUBMITTED, so commits
    2 and 3 arrive while its future is unresolved: resync defers both
    repairs and pop applies them in epoch order. Bit for bit against the
    sync device tier; the hook log shows the race happened."""
    gate = threading.Event()
    events = []

    def on_retrieve_start(w):
        if w == 5:
            assert gate.wait(timeout=60), "commit 3 never submitted"
        events.append(("retrieve", w))

    def on_commit_submit(epoch):
        events.append(("commit_submit", epoch))
        if epoch == 3:
            gate.set()

    hooks = {"retrieve_start": on_retrieve_start,
             "commit_submit": on_commit_submit}
    ref_state, ref_stats, _ = run_tier(init_state, "device", steps=7)
    state, stats, _ = run_tier(init_state, tier, steps=7, async_on=True,
                               lookahead=3, hooks=hooks)
    assert stats.losses == ref_stats.losses
    assert _same(state, ref_state)
    r5 = events.index(("retrieve", 5))
    assert ("commit_submit", 2) in events[:r5]
    assert ("commit_submit", 3) in events[:r5]


# ---------------------------------------------------------------------------
# plumbing: resolution, timers, serial, the pool
# ---------------------------------------------------------------------------


def test_resolve_async_stages_precedence(monkeypatch):
    assert resolve_async_stages(None) is False
    assert resolve_async_stages("auto") is False
    assert resolve_async_stages("on") is True
    assert resolve_async_stages(True) is True
    monkeypatch.setenv("REPRO_ASYNC_STAGES", "on")
    assert resolve_async_stages("auto") is True  # env fills the auto hole
    assert resolve_async_stages("off") is False  # explicit arg wins
    with pytest.raises(ValueError, match="async_stages"):
        resolve_async_stages("sideways")


def test_env_switch_reaches_the_session(monkeypatch):
    """``$REPRO_ASYNC_STAGES`` turns the executor on through ``Session``,
    and ``Session.from_arch(async_stages=...)`` overrides it."""
    monkeypatch.setenv("REPRO_ASYNC_STAGES", "on")
    rep = Session.from_arch(ARCH, store="host", **KW).train(2)
    assert rep.summary["async_stages"] is True
    rep = Session.from_arch(ARCH, store="host", async_stages="off", **KW).train(2)
    assert rep.summary["async_stages"] is False


def test_stage_timers_surface_in_metrics_and_summary(init_state):
    for tier, async_on in (("host", False), ("cached", True)):
        _, stats, _ = run_tier(init_state, tier, async_on=async_on)
        m = stats.store_metrics
        for k in ("plan_ms", "retrieve_ms", "commit_ms", "h2d_ms"):
            assert k in m and m[k] >= 0.0, (tier, k, m)
        assert m["plan_ms"] > 0 and m["retrieve_ms"] > 0 and m["commit_ms"] > 0
        s = stats.summary()
        assert s["plan_ms"] == m["plan_ms"]
        assert s["async_stages"] is async_on


def test_serial_mode_ignores_async_stages(monkeypatch):
    """The serial baseline has no host stages to move; the env switch
    must not break it."""
    monkeypatch.setenv("REPRO_ASYNC_STAGES", "on")
    sess = Session.from_arch(ARCH, mode="serial", **KW)
    driver = sess.strategy.build_driver(
        sess.fns, resolve_stream(sess.workload, sess.seed), sess.workload)
    assert driver.async_stages is False
    _, stats = driver.run(sess._take_state(), 2)
    assert len(stats.losses) == 2


def test_fence_slack_defaults():
    """lookahead + 1 on host tiers in nestpipe mode, 0 on the device tier
    and for the staleness baseline (the JAX driver's rule)."""
    def slack(store, mode="nestpipe", lookahead=1):
        sess = Session.from_arch(ARCH, mode=mode, store=store,
                                 prefetch_ahead=lookahead, **KW)
        return sess.strategy.build_driver(
            sess.fns, iter(()), sess.workload).fence_slack
    assert slack("host") == 2 and slack("cached", lookahead=3) == 4
    assert slack("device") == 0 and slack("host", mode="async") == 0


def test_prefetcher_pop_fallback_fetches_exactly_one():
    """``pop`` on an empty queue fetches one window, never ``depth``."""
    calls = []

    class OneShotStore:
        def plan(self, keys):
            return ("plan", len(calls))

        def retrieve(self, plan):
            return ("buf", plan)

    def next_batch():
        calls.append(1)
        return {"keys": np.zeros(4, np.int32)}

    pf = Prefetcher(next_batch, OneShotStore(), depth=3)
    assert pf.pop() is not None
    assert len(calls) == 1


def test_input_wait_running_sum_matches_list(init_state):
    _, stats, _ = run_tier(init_state, "host", async_on=True)
    assert np.isclose(stats.input_wait_total, sum(stats.input_wait_times))
    assert len(stats.input_wait_times) > 0


def test_cpu_staging_is_fresh_every_call(init_state):
    """Staging is fresh on every call, on the executor's workers as in the
    synchronous loop (no tensor is reused by hand): on the CPU two stages
    of the same keys share no memory, and a later write to the master
    leaves a staged buffer as it was (bit for bit)."""
    _, _, store = run_tier(init_state, "host", async_on=True)
    assert isinstance(store, HostStore)
    keys = np.array([1, 3, 4, SENTINEL], np.int32)
    a, b = store.stage(keys), store.stage(keys)
    assert a.rows.data_ptr() != b.rows.data_ptr()
    assert a.accum.data_ptr() != b.accum.data_ptr()
    want = store.rows[[1, 3, 4]].clone()
    assert torch.equal(a.rows[:3], want) and not a.rows[3].any()
    store.rows[[1, 3, 4]] += 1.0
    store.accum[[1, 3, 4]] += 1.0
    assert torch.equal(a.rows[:3], want) and torch.equal(b.rows[:3], want)
    assert torch.equal(a.accum, b.accum)


# ---------------------------------------------------------------------------
# property: the epoch-fence repair converges to the synchronous replay
# under random interleavings and random fence_slack
# ---------------------------------------------------------------------------


class _ReplayStore:
    """A pure-Python store over a float64 vector master; every host stage
    sleeps a seed-determined random time, so each example runs another
    commit-vs-retrieve interleaving through the executor."""

    tier = "host"

    def __init__(self, n_rows, seed=None):
        self.master = np.arange(n_rows, dtype=np.float64) * 0.5
        self._rng = random.Random(seed) if seed is not None else None

    def _jitter(self):
        if self._rng is not None:
            time.sleep(self._rng.random() * 0.003)

    def route(self, keys):
        return np.asarray(keys)

    def plan_from_window(self, window, after=None):
        self._jitter()
        return FetchPlan(None, window)

    def plan(self, keys):
        return self.plan_from_window(self.route(keys))

    def retrieve(self, plan):
        self._jitter()
        keys = plan.host_keys
        return DualBuffer(keys, self.master[keys].copy(), np.zeros(len(keys)))

    def commit(self, buffer, plan=None):
        self._jitter()
        self.master[buffer.keys] = buffer.rows


def _toy_sync(updated: DualBuffer, pre: DualBuffer) -> DualBuffer:
    """Prop. 1 intersection copy (sorted unique keys, no sentinels)."""
    rows = pre.rows.copy()
    pos = np.minimum(np.searchsorted(updated.keys, pre.keys),
                     len(updated.keys) - 1)
    hit = updated.keys[pos] == pre.keys
    rows[hit] = updated.rows[pos[hit]]
    return DualBuffer(pre.keys, rows, pre.accum)


def _toy_windows(steps, n_rows, keys_per_window, data_seed):
    rng = np.random.default_rng(data_seed)
    return [np.sort(rng.choice(n_rows, size=keys_per_window, replace=False))
            for _ in range(steps)]


def _drive(pf, commit_fn, windows):
    """The DBPDriver's steady loop, distilled; the window update depends
    only on (key, t), so any schedule that repairs staleness exactly gives
    one trajectory."""
    steps = len(windows)
    losses = []
    pf.fill(limit=steps)
    first = pf.pop()
    buffer, plan = first.buffer, first.plan
    for t in range(steps):
        pf.fill(limit=steps - 1 - t)
        buffer = DualBuffer(buffer.keys,
                            buffer.rows + (buffer.keys + 1.0) * (t + 1),
                            buffer.accum)
        if t + 1 < steps:
            nxt = pf.pop()
            nxt_buf = _toy_sync(buffer, nxt.buffer)
            pf.resync(buffer, _toy_sync)
        commit_fn(buffer, plan)
        losses.append(float(buffer.rows.sum()))
        if t + 1 < steps:
            buffer, plan = nxt_buf, nxt.plan
    return losses


def _reference(windows, n_rows):
    """The fully synchronous replay (no pipeline)."""
    master = np.arange(n_rows, dtype=np.float64) * 0.5
    losses = []
    for t, keys in enumerate(windows):
        rows = master[keys] + (keys + 1.0) * (t + 1)
        master[keys] = rows
        losses.append(float(rows.sum()))
    return master, losses


@settings(max_examples=12, deadline=None)
@given(fence_slack=st.integers(0, 3), lookahead=st.integers(1, 3),
       seed=st.integers(0, 63))
def test_epoch_fence_repair_converges_for_any_schedule(fence_slack,
                                                       lookahead, seed):
    """Any interleaving the executor can produce (random stage delays,
    fence_slack, lookahead) gives the synchronous replay's losses and
    master exactly; ``strict=True`` also asserts the repair count at every
    pop."""
    n_rows, steps = 24, 12
    windows = _toy_windows(steps, n_rows, keys_per_window=6,
                           data_seed=seed % 7)
    ref_master, ref_losses = _reference(windows, n_rows)
    store = _ReplayStore(n_rows, seed=seed)
    batches = iter([{"keys": k} for k in windows])
    ex = StageExecutor(store, workers=1, fence_slack=fence_slack)
    try:
        pf = AsyncPrefetcher(lambda: next(batches), store, ex,
                             depth=lookahead, strict=True)
        losses = _drive(pf, ex.submit_commit, windows)
        ex.drain()
    finally:
        ex.shutdown()
    assert losses == ref_losses, (fence_slack, lookahead, seed)
    np.testing.assert_array_equal(store.master, ref_master)


def test_replay_loop_matches_reference_synchronously():
    """The toy harness is honest: through the synchronous Prefetcher it
    gives the reference too, so the property tests the executor."""
    n_rows, steps = 24, 10
    for lookahead in (1, 2, 3):
        windows = _toy_windows(steps, n_rows, 6, data_seed=3)
        ref_master, ref_losses = _reference(windows, n_rows)
        store = _ReplayStore(n_rows)
        batches = iter([{"keys": k} for k in windows])
        pf = Prefetcher(lambda: next(batches), store, depth=lookahead)
        losses = _drive(pf, store.commit, windows)
        assert losses == ref_losses
        np.testing.assert_array_equal(store.master, ref_master)


# ---------------------------------------------------------------------------
# failures surface on the driver thread
# ---------------------------------------------------------------------------


def test_executor_propagates_worker_errors():
    class BoomStore:
        def route(self, keys):
            return "window"  # the driver-side half is fine

        def plan_from_window(self, window, after=None):
            raise RuntimeError("boom in plan")  # the worker-side half fails

        def retrieve(self, plan):  # pragma: no cover
            return None

        def commit(self, buffer, plan):  # pragma: no cover
            return None

    ex = StageExecutor(BoomStore())
    try:
        fut = ex.submit_retrieve(np.zeros(2, np.int32), window=0)
        with pytest.raises(RuntimeError, match="boom in plan"):
            fut.result(timeout=30)
        assert ex.first_stage_failure()[:2] == ("plan", 0)
    finally:
        ex.shutdown()


def test_failed_stage_raises_at_the_next_pop_labelled(init_state, monkeypatch):
    """A retrieve that fails on a worker fails the run at the next pop,
    labelled by stage and window, with the original error chained."""
    real = HostStore.retrieve

    def boom(self, plan):
        if getattr(self, "_calls", 0) == 2:
            raise RuntimeError("boom in retrieve")
        self._calls = getattr(self, "_calls", 0) + 1
        return real(self, plan)

    monkeypatch.setattr(HostStore, "retrieve", boom)
    with pytest.raises(RuntimeError, match="retrieve stage failed at window 2") as ei:
        run_tier(init_state, "host", async_on=True, lookahead=3)
    assert "boom in retrieve" in str(ei.value.__cause__)


def test_commit_failure_unblocks_fenced_retrieves():
    """A failed commit never bumps the epoch: a fenced retrieve raises
    instead of waiting forever, and ``drain`` re-raises it."""
    class CommitBoomStore:
        tier = "device"

        def route(self, keys):
            return "window"

        def plan_from_window(self, window, after=None):
            return "plan"

        def retrieve(self, plan):  # pragma: no cover
            return "buf"

        def commit(self, buffer, plan):
            raise RuntimeError("boom in commit")

    ex = StageExecutor(CommitBoomStore())
    try:
        cfut = ex.submit_commit("buf", "plan")
        with pytest.raises(RuntimeError, match="boom in commit"):
            cfut.result(timeout=30)
        rfut = ex.submit_retrieve(np.zeros(2, np.int32), window=1)
        with pytest.raises(RuntimeError, match="commit stage failed"):
            rfut.result(timeout=30)
        with pytest.raises(RuntimeError, match="boom in commit"):
            ex.drain()
    finally:
        ex.shutdown()
