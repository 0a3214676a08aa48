"""The host and cached embedding tiers: the port against itself and
against the JAX package (``tests/test_hierarchical.py`` and
``tests/test_store.py`` mirrored).

Workload: the reduced ``dlrm-ctr`` (``global_batch=32``, N = 4,
``bucket_slack=4.0``), 5 steps, on the CPU.

- Bit for bit (``torch.equal`` / ``assert_array_equal``): the device, host
  and cached tiers of the port replay one trajectory, losses and the whole
  master (rows and adagrad state); the cached tier stays exact under
  eviction (``chunk_rows`` 1, and 4 with ``lru``); ``mode="async"`` and
  lookahead 3 too; staged buffers never share memory with the master or
  each other; an export is a snapshot.
- Against JAX, from the JAX session's initial state
  (``convert.train_state_from_jax``): losses and master within 1e-5, the
  trajectory tolerance of ``tests/test_torch_train.py`` (f32 matmuls add
  in another order on XLA:CPU); the store counters (cache hits, misses,
  evictions, bursts, bytes each way, rows used, wire and index bytes)
  exactly equal. At bf16 compute each port tier holds to its own JAX tier
  within 1e-5: the device tier rounds what it retrieves to bf16, the host
  tiers do not, so host and device differ there, in both packages alike.
- Tier choice: ``$REPRO_STORE`` resolution, serial's handling, the
  placeholder, the counters in the summary, the CLI.
"""
import os
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.api import Session as JSession
from repro.api.streams import resolve_stream as jresolve_stream
from repro.core.store import CachedStore as JCachedStore
from repro.core.store import HostStore as JHostStore
from repro_torch.api import Session, resolve_stream
from repro_torch.convert import train_state_from_jax
from repro_torch.core.store import (
    STORES,
    CachedStore,
    DeviceStore,
    EmbeddingStore,
    FetchPlan,
    HostStore,
    SparseComm,
    build_store,
    placeholder_table,
    resolve_store,
)
from repro_torch.core.embedding.routing import SENTINEL
from repro_torch.train import clone_state

ARCH = "dlrm-ctr"  # reduced: 3 tables, 5 feature slots, dim 16
KW = dict(reduced=True, global_batch=32, n_micro=4)
STEPS = 5
# store counters both packages keep, compared exactly
COUNTERS = ("cache_hits", "cache_misses", "cache_evictions", "h2d_bursts",
            "d2h_bursts", "h2d_bytes", "d2h_bytes", "cache_rows_used",
            "wire_bytes", "idx_bytes")


def _np(x):
    return np.array(x, copy=True)  # the JAX run donates its input buffers


@pytest.fixture(autouse=True)
def _no_tier_env(monkeypatch):
    for var in ("REPRO_STORE", "REPRO_CACHE_POLICY", "REPRO_SPARSE_COMM"):
        monkeypatch.delenv(var, raising=False)


def _session(**kw):
    return Session.from_arch(ARCH, device="cpu", **KW, **kw)


def _port_store(tier, sess, **store_kw):
    wl = sess.workload
    return {"device": lambda: DeviceStore(wl.engine, n_micro=wl.n_micro),
            "host": lambda: HostStore(wl.engine, n_micro=wl.n_micro, **store_kw),
            "cached": lambda: CachedStore(wl.engine, n_micro=wl.n_micro,
                                          **store_kw)}[tier]()


def run_port(tier, *, init=None, mode="nestpipe", lookahead=1, steps=STEPS,
             **store_kw):
    """Train ``steps`` steps through ``tier`` from ``init`` (default: the
    seed-0 session's state). Returns (state, stats, store)."""
    sess = _session(mode=mode, prefetch_ahead=lookahead)
    if init is not None:
        sess.state = clone_state(init)
    store = _port_store(tier, sess, **store_kw)
    driver = sess.strategy.build_driver(
        sess.fns, resolve_stream(sess.workload, sess.seed), sess.workload,
        store=store)
    state, stats = driver.run(clone_state(sess.state), steps)
    return state, stats, store


def _same(a, b):
    return torch.equal(a.table.rows, b.table.rows) and \
        torch.equal(a.table.accum, b.table.accum)


# ---------------------------------------------------------------------------
# three tiers, one trajectory, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def device_run():
    return run_port("device")


def test_three_tiers_replay_bit_for_bit(device_run):
    state_d, stats_d, _ = device_run
    for tier in ("host", "cached"):
        state, stats, _ = run_port(tier)
        assert stats.losses == stats_d.losses, tier
        assert _same(state, state_d), tier


@pytest.mark.parametrize("chunk_rows,policy", [(1, None), (4, "lru")])
def test_cached_tier_eviction_stays_bit_exact(device_run, chunk_rows, policy):
    """A cache of 32 rows must evict (write back to the master) and still
    replay the device trajectory: row-granular, and whole-chunk victims
    under an always-displace policy."""
    state_d, stats_d, _ = device_run
    state, stats, store = run_port("cached", capacity=32, miss_bucket=8,
                                   chunk_rows=chunk_rows, policy=policy)
    assert store.evictions > 0
    assert stats.losses == stats_d.losses
    assert _same(state, state_d)


def test_async_mode_rides_every_tier():
    """The staleness baseline flows through the same store seam."""
    _, stats_d, _ = run_port("device", mode="async")
    for tier in ("host", "cached"):
        assert run_port(tier, mode="async")[1].losses == stats_d.losses, tier


def test_lookahead_prefetch_is_exact(device_run):
    """Prefetch depth 3 (retrieval three steps early, re-synced at every
    commit) keeps the trajectory, on every tier."""
    _, stats_1, _ = device_run
    for tier in STORES:
        _, stats_k, _ = run_port(tier, lookahead=3)
        assert stats_k.losses == stats_1.losses, tier


def test_serial_mode_rejects_host_tiers():
    with pytest.raises(ValueError, match="serial"):
        run_port("host", mode="serial")
    with pytest.raises(ValueError, match="serial"):
        _session(mode="serial", store="cached").train(1)


# ---------------------------------------------------------------------------
# host-tier plumbing
# ---------------------------------------------------------------------------


def _tiny_host_store(cls=HostStore, **kw):
    sess = _session()
    return sess, cls.from_device_table(sess.workload.engine, sess.state.table, **kw)


def _keys(spec, n=32, pad=40):
    keys = np.sort(np.unique(np.random.default_rng(0).integers(
        0, spec.padded_rows, n))).astype(np.int32)
    return np.pad(keys, (0, pad - len(keys)), constant_values=SENTINEL)


def test_staged_buffers_are_independent():
    """Back-to-back stages (the lookahead pattern) hand out buffers that
    share memory with neither the master nor each other: a later stage or
    a master mutation never leaks into an earlier buffer."""
    sess, host = _tiny_host_store()
    keys = _keys(host.spec)
    b1 = host.stage(keys)
    before = host.rows[int(keys[0])].clone()
    host.rows[:] = -123.0  # commit-like master mutation
    b2 = host.stage(keys)
    assert torch.equal(b1.rows[0], before)
    assert float(b2.rows[0, 0]) == -123.0
    assert not torch.equal(b1.rows, b2.rows)
    for buf in (b1, b2):
        assert float(buf.rows[-1].abs().sum()) == 0.0  # sentinel slots zeroed
        assert buf.rows.untyped_storage().data_ptr() != \
            host.rows.untyped_storage().data_ptr()


def test_export_table_is_a_snapshot():
    sess, host = _tiny_host_store()
    exported = host.export_table().rows
    before = exported.clone()
    host.rows[:] = -7.0  # commit-like master mutation after the export
    assert torch.equal(exported, before)


def test_host_traffic_accounting():
    """One staged buffer per retrieve (H2D) and one pulled buffer per
    commit (D2H): a finite run retrieves as many windows as it commits."""
    _, stats, store = run_port("host")
    assert store.h2d_bytes % STEPS == 0
    per_retrieve = store.h2d_bytes // STEPS
    assert store.d2h_bytes == STEPS * per_retrieve
    assert stats.store_metrics["h2d_bytes"] == float(store.h2d_bytes)


def test_from_device_table_builds_complete_subclass():
    sess, cached = _tiny_host_store(CachedStore, capacity=64)
    table = sess.state.table
    assert cached.capacity == 64
    assert tuple(cached.cache_rows.shape) == (64, cached.spec.dim)
    assert cached.cap_chunks == 64 // cached.chunk_rows
    assert cached._chunk_of_slot.shape == (cached.cap_chunks,)
    assert cached._slot_of_chunk == {} and cached.hits == cached.misses == 0
    assert torch.equal(cached.rows, table.rows)
    keys = np.full((16,), SENTINEL, np.int32)
    keys[:4] = [1, 5, 9, 13]
    buf = cached.retrieve(FetchPlan(None, keys))
    assert torch.equal(buf.rows[:4], table.rows[[1, 5, 9, 13]])
    assert not buf.rows[4:].any() and cached.misses == 4


def test_cached_assembly_equals_the_concatenated_form():
    """The buffer assembled by two gathers and a select equals, bit for
    bit, a gather from ``cat([cache, staged misses])`` (the JAX form), with
    the cache full of negative zeros so a sum of the two would show."""
    sess, cached = _tiny_host_store(CachedStore, capacity=32, chunk_rows=4)
    cached.rows[:] = -0.0
    cached.cache_rows[:] = -0.0
    cap = cached.capacity
    rng = np.random.default_rng(5)
    for _ in range(4):
        keys = np.unique(rng.integers(0, cached.spec.padded_rows, 12)).astype(np.int32)
        keys = np.pad(keys, (0, 16 - len(keys)), constant_values=SENTINEL)
        miss = torch.randn((24, cached.spec.dim))
        miss_acc = torch.rand(24)
        src = torch.from_numpy(rng.integers(0, cap + 25, 16).astype(np.int32))
        got = cached._assemble(src, torch.from_numpy(keys), miss, miss_acc)
        cat = torch.cat([cached.cache_rows, miss])
        ok = src < cap + 24
        want = torch.where(ok[:, None], cat[src.clamp(max=cap + 23).long()], 0.0)
        assert torch.equal(got.rows, want)
        assert torch.equal(torch.signbit(got.rows), torch.signbit(want))
        cat_acc = torch.cat([cached.cache_accum, miss_acc])
        assert torch.equal(got.accum, torch.where(
            ok, cat_acc[src.clamp(max=cap + 23).long()], 0.0))


def test_host_tier_run_holds_no_device_master_reference():
    """The session hands its state over and the driver rebinds it after
    ingest: during a host-tier run nothing keeps the old master alive (on
    the card, that frees the device copy)."""
    sess = _session(store="host")
    ref = weakref.ref(sess.state.table.rows)
    alive = []
    real = HostStore.retrieve

    def spy(self, plan):
        alive.append(ref() is not None)
        return real(self, plan)

    HostStore.retrieve = spy
    try:
        rep = sess.train(2)
    finally:
        HostStore.retrieve = real
    assert alive and not any(alive)
    assert rep.summary["store"] == "host"
    assert tuple(sess.state.table.rows.shape) == (sess.workload.spec.padded_rows,
                                                  sess.workload.spec.dim)


def test_a_failed_run_does_not_redraw_the_state(monkeypatch):
    sess = _session(store="host")
    sess.state  # drawn

    def boom(self, plan):
        raise RuntimeError("injected")

    monkeypatch.setattr(HostStore, "retrieve", boom)
    with pytest.raises(RuntimeError, match="injected"):
        sess.train(1)
    with pytest.raises(RuntimeError, match="train run that failed"):
        sess.state


# ---------------------------------------------------------------------------
# tier choice: config > $REPRO_STORE > device; serial; counters
# ---------------------------------------------------------------------------


def test_resolve_store_precedence(monkeypatch):
    assert resolve_store(None) == "device"
    assert resolve_store("auto") == "device"
    assert resolve_store("cached") == "cached"
    monkeypatch.setenv("REPRO_STORE", "host")
    assert resolve_store("auto") == "host"  # env fills the auto hole
    assert resolve_store("cached") == "cached"  # explicit config wins
    with pytest.raises(ValueError, match="unknown embedding store"):
        resolve_store("hbm3")
    assert set(STORES) == {"device", "host", "cached"}


def test_env_override_reaches_the_driver(monkeypatch):
    monkeypatch.setenv("REPRO_STORE", "host")
    rep = _session().train(2)
    assert rep.summary["store"] == "host"
    assert rep.summary["h2d_bytes"] > 0


def test_serial_mode_store_handling(monkeypatch):
    """An explicit host tier with serial raises; ``$REPRO_STORE`` under
    serial falls back to the device tier."""
    with pytest.raises(ValueError, match="serial"):
        _session(mode="serial", store="host").train(1)
    monkeypatch.setenv("REPRO_STORE", "cached")
    rep = _session(mode="serial").train(1)
    assert rep.summary["store"] == "device"


def test_build_store_builds_every_tier_and_validates():
    sess = _session()
    eng = sess.workload.engine
    assert isinstance(build_store("device", eng), DeviceStore)
    host = build_store("host", eng, n_micro=4)
    assert type(host) is HostStore and host.n_micro == 4
    cached = build_store("cached", eng, cache_rows=64, cache_chunk_rows=4,
                         cache_policy="lru", prefetch_ahead=2)
    assert (cached.capacity, cached.chunk_rows, cached._policy.name,
            cached.horizon_windows) == (64, 4, "lru", 3)
    with pytest.raises(ValueError, match="cache_policy"):
        build_store("device", eng, cache_policy="sideways")
    for mode in ("pack", "int8"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_store("host", eng, sparse_comm=mode)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SparseComm(mode)
    with pytest.raises(ValueError, match="sparse_comm"):
        build_store("device", eng, sparse_comm="zstd")


def test_every_tier_is_an_embedding_store():
    sess = _session()
    for tier in STORES:
        store = _port_store(tier, sess)
        assert isinstance(store, EmbeddingStore) and store.tier == tier
        assert store.sparse_comm == "off"


def test_placeholder_table_is_zero_row():
    table = _session().state.table
    ph = placeholder_table(table)
    assert tuple(ph.rows.shape) == (0, table.rows.shape[1])
    assert tuple(ph.accum.shape) == (0,)


def test_store_counters_surface_in_summary():
    rep_h = _session(store="host").train(4)
    assert rep_h.summary["store"] == "host"
    assert rep_h.summary["h2d_bytes"] > 0 and rep_h.summary["d2h_bytes"] > 0
    rep_c = _session(store="cached").train(4)
    s = rep_c.summary
    assert s["store"] == "cached" and s["sparse_comm"] == "off"
    assert 0.0 <= s["cache_hit_rate"] <= 1.0
    assert "cache_hit_rate_steady" in s and s["h2d_bursts"] > 0
    # the cache exists to shrink H2D staging: far less than the host tier
    assert s["h2d_bytes"] < rep_h.summary["h2d_bytes"]
    assert rep_c.stats.store_metrics_warm  # the warm-up snapshot
    rep_d = _session(store="device").train(2)
    assert rep_d.summary["store"] == "device"
    assert "h2d_bytes" not in rep_d.summary  # no host master traffic


def test_cli_trains_through_the_cached_tier(capsys, monkeypatch):
    from repro_torch.launch.train import train

    monkeypatch.setenv("REPRO_CACHE_POLICY", "oracle")
    _, stats = train(["--arch", "dlrm-drift", "--reduced", "--device", "cpu",
                      "--store", "cached", "--steps", "4", "--global-batch", "16"])
    assert stats.store_tier == "cached" and len(stats.losses) == 4
    out = capsys.readouterr().out
    assert '"store": "cached"' in out and '"h2d_bursts"' in out


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _jax_run(tier, compute_dtype=None, **store_kw):
    """The JAX session's initial state (numpy) and its run through
    ``tier``, with the store built from ``store_kw``."""
    js = JSession.from_arch(ARCH, store="device", **KW)
    if compute_dtype is not None:
        js.workload.engine.compute_dtype = compute_dtype
    init = jax.tree.map(_np, js.state)
    spec, fns = js.workload.spec, js.fns
    store = {"host": lambda: JHostStore(spec, fns, **store_kw),
             "cached": lambda: JCachedStore(spec, fns, **store_kw)}.get(tier)
    driver = js.strategy.build_driver(
        fns, jresolve_stream(js.workload, js.data_seed), js.workload,
        **({"store": store()} if store else {}))
    state, stats = driver.run(js.state, STEPS)
    return init, stats, jax.tree.map(_np, state.table)


def _port_run_from(init, tier, compute_dtype=None, **store_kw):
    sess = _session()
    if compute_dtype is not None:
        sess.workload.engine.compute_dtype = compute_dtype
    sess.state = train_state_from_jax(init, "cpu")
    store = _port_store(tier, sess, **store_kw)
    driver = sess.strategy.build_driver(
        sess.fns, resolve_stream(sess.workload, sess.seed), sess.workload,
        store=store)
    return driver.run(clone_state(sess.state), STEPS)


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@pytest.mark.parametrize("tier,store_kw", [
    ("host", {}),
    ("cached", {}),
    ("cached", dict(capacity=32, miss_bucket=8, chunk_rows=1)),
    ("cached", dict(capacity=32, miss_bucket=8, chunk_rows=3, policy="oracle")),
], ids=["host", "cached", "cached-chunk1", "cached-chunk3-oracle"])
def test_tiers_match_jax(tier, store_kw):
    init, jstats, jtable = _jax_run(tier, **store_kw)
    state, stats = _port_run_from(init, tier, **store_kw)
    np.testing.assert_allclose(stats.losses, jstats.losses, rtol=0, atol=1e-5)
    assert _max_diff(state.table.rows, jtable.rows) <= 1e-5
    assert _max_diff(state.table.accum, jtable.accum) <= 1e-5
    jm, pm = jstats.store_metrics, stats.store_metrics
    for k in COUNTERS:
        if k in jm:
            assert pm[k] == jm[k], k
    assert set(jm) & set(COUNTERS) <= set(pm)
    summary, jsummary = stats.summary(), jstats.summary()
    for k in ("cache_hit_rate", "cache_hit_rate_steady", "h2d_bursts"):
        assert summary.get(k) == jsummary.get(k), k


@pytest.mark.parametrize("tier", STORES)
def test_tiers_match_jax_at_bf16_compute(tier):
    """Each tier against its own JAX tier at bf16 compute (1e-5); the
    host tiers stage raw rows where the device tier rounds to bf16."""
    init, jstats, jtable = _jax_run(tier, compute_dtype=jnp.bfloat16)
    state, stats = _port_run_from(init, tier, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(stats.losses, jstats.losses, rtol=0, atol=1e-5)
    assert _max_diff(state.table.rows, jtable.rows) <= 1e-5
    assert _max_diff(state.table.accum, jtable.accum) <= 1e-5


def test_host_tier_stages_raw_rows_at_bf16_compute():
    """At bf16 compute the device tier's buffer holds bf16-rounded rows and
    the host tiers' the master's own bits, in both packages."""
    sess = _session()
    sess.workload.engine.compute_dtype = torch.bfloat16
    table = sess.state.table
    keys = _keys(sess.workload.spec)
    host = HostStore.from_device_table(sess.workload.engine, table).stage(keys)
    dev = DeviceStore(sess.workload.engine)
    dev.ingest(table)
    window = sess.workload.engine.route_window(
        torch.from_numpy(keys[None, None, :8].astype(np.int32)), 1)
    plan = FetchPlan(window._replace(buffer_keys=torch.from_numpy(keys)), keys)
    rounded = dev.retrieve(plan)
    valid = torch.from_numpy(keys != SENTINEL)
    idx = torch.from_numpy(keys[keys != SENTINEL].astype(np.int64))
    assert torch.equal(host.rows[valid], table.rows[idx])
    assert torch.equal(rounded.rows[valid], table.rows[idx].to(torch.bfloat16).float())
    assert not torch.equal(host.rows, rounded.rows)
