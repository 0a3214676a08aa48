"""The port's sparse-path wire modes (``repro_torch.core.store.comm`` and
``repro_torch.dist.compressed``) against the JAX package's and against the
port's own ``off`` mode, case for case with ``tests/test_sparse_comm.py``
(its sharded cases come with the port's sharded tier).

- Codec and quantizer: the port's numpy copies against JAX's on the same
  numpy inputs, bit for bit (packed bytes, ``nbytes``, widths, dtypes,
  quantized values, scales and errors).
- ``SparseComm`` laws: the same answers as JAX's object on the same
  inputs, bit for bit (pads, index dtypes, counters, the int8 write-back
  into the master and its residual and RNG draws).
- Pipeline, reduced ``dlrm-ctr`` (``global_batch=32``, N = 4,
  ``bucket_slack=4.0``), 5 steps on the CPU: ``pack`` replays ``off`` bit
  for bit on the host and cached tiers, sync and async, and under
  eviction; against JAX, ``pack`` and ``int8`` trajectories within 1e-5
  (the f32 matmuls of the two packages add in other orders, as in
  ``tests/test_torch_store.py``) with the byte and sync ledgers exactly
  equal.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _hypothesis_compat import given, settings, st

from repro.api import Session as JSession
from repro.api.streams import resolve_stream as jresolve_stream
from repro.core.store import CachedStore as JCachedStore
from repro.core.store import HostStore as JHostStore
from repro.core.store import PACK_PAD as JPACK_PAD
from repro.core.store import SparseComm as JSparseComm
from repro.dist import compressed as jc
from repro_torch.api import Session, resolve_stream
from repro_torch.convert import train_state_from_jax
from repro_torch.core.store import (
    PACK_PAD,
    SPARSE_COMMS,
    CachedStore,
    HostStore,
    SparseComm,
    build_store,
    resolve_sparse_comm,
)
from repro_torch.dist import compressed as tc
from repro_torch.serve import FrozenStoreView
from repro_torch.train import clone_state

SENTINEL = np.iinfo(np.int32).max
ARCH = "dlrm-ctr"
KW = dict(reduced=True, global_batch=32, n_micro=4)
STEPS = 5
# the ledgers both packages keep, compared exactly
LEDGER = ("h2d_bytes", "d2h_bytes", "wire_bytes", "idx_bytes",
          "comm_rows_synced", "comm_rows_deferred", "cache_hits",
          "cache_misses", "h2d_bursts")


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for var in ("REPRO_STORE", "REPRO_CACHE_POLICY", "REPRO_SPARSE_COMM",
                "REPRO_ASYNC_STAGES"):
        monkeypatch.delenv(var, raising=False)


def _same_packed(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    assert a.data.dtype == b.data.dtype == np.uint8
    assert (a.n, a.first, a.width, a.nbytes) == (b.n, b.first, b.width, b.nbytes)


# ---------------------------------------------------------------------------
# the codec and the quantizer: the port's copies equal JAX's bit for bit
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(n=st.integers(0, 400), span=st.integers(1, 1 << 40),
       wide=st.booleans())
def test_pack_roundtrip_exact_and_equals_jax(n, span, wide):
    rng = np.random.default_rng(n * 1000003 + span % 997)
    dtype = np.int64 if wide else np.int32
    hi = min(span, np.iinfo(dtype).max - 1)
    keys = np.sort(rng.integers(0, hi + 1, size=n)).astype(dtype)
    packed = tc.pack_sorted_keys(keys)
    _same_packed(packed, jc.pack_sorted_keys(keys))
    out = tc.unpack_sorted_keys(packed, dtype)
    np.testing.assert_array_equal(out, keys)
    assert out.dtype == dtype
    assert packed.nbytes >= tc.PACK_HEADER_BYTES == jc.PACK_HEADER_BYTES


def test_pack_edge_cases():
    for keys in (np.array([], np.int64), np.array([7], np.int32),
                 np.full(17, 42, np.int64),
                 np.array([0, 1, 1, 2, SENTINEL, SENTINEL], np.int64)):
        packed = tc.pack_sorted_keys(keys)
        _same_packed(packed, jc.pack_sorted_keys(keys))
        np.testing.assert_array_equal(tc.unpack_sorted_keys(packed, keys.dtype),
                                      keys)


def test_pack_rejects_unsorted():
    with pytest.raises(ValueError):
        tc.pack_sorted_keys(np.array([3, 1, 2], np.int64))


@settings(max_examples=15, deadline=None)
@given(n=st.integers(1, 200))
def test_pack_small_deltas_beat_raw(n):
    keys = np.arange(n, dtype=np.int64) + 5
    packed = tc.pack_sorted_keys(keys)
    assert packed.nbytes <= tc.PACK_HEADER_BYTES + (n - 1 + 7) // 8


def test_min_index_dtype():
    for v in (0, 255, 256, 65535, 1 << 16, (1 << 32) - 1, 1 << 40):
        assert tc.min_index_dtype(v) == jc.min_index_dtype(v)
    assert tc.min_index_dtype(255) == np.uint8
    assert tc.min_index_dtype(256) == np.uint16
    assert tc.min_index_dtype(1 << 16) == np.uint32
    assert tc.min_index_dtype(1 << 40) == np.int64


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 64), d=st.integers(1, 48),
       scale_pow=st.integers(-8, 8))
def test_quantize_error_bound_and_equals_jax(n, d, scale_pow):
    rng = np.random.default_rng(n * 131 + d)
    rows = (rng.standard_normal((n, d)) * 10.0 ** scale_pow).astype(np.float32)
    q, scales, err = tc.quantize_rows_np(rows)
    jq, jscales, jerr = jc.quantize_rows_np(rows)
    for a, b in ((q, jq), (scales, jscales), (err, jerr)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert q.dtype == np.int8 and scales.shape == (n,)
    deq = tc.dequantize_rows_np(q, scales)
    np.testing.assert_array_equal(deq, jc.dequantize_rows_np(jq, jscales))
    assert np.all(np.abs(rows - deq) <= scales[:, None] / 2 + 1e-30)
    np.testing.assert_array_equal(err, rows - deq)


def test_quantize_zero_rows():
    rows = np.zeros((3, 4), np.float32)
    q, scales, err = tc.quantize_rows_np(rows)
    assert np.all(q == 0) and np.all(err == 0)
    np.testing.assert_array_equal(tc.dequantize_rows_np(q, scales), rows)


# ---------------------------------------------------------------------------
# SparseComm laws
# ---------------------------------------------------------------------------


def test_resolve_precedence(monkeypatch):
    assert resolve_sparse_comm() == "off"
    assert resolve_sparse_comm("auto") == "off"
    monkeypatch.setenv("REPRO_SPARSE_COMM", "pack")
    assert resolve_sparse_comm() == "pack"
    assert resolve_sparse_comm("int8") == "int8"  # arg beats env
    with pytest.raises(ValueError, match="sparse_comm"):
        resolve_sparse_comm("gzip")
    assert tuple(SPARSE_COMMS) == ("off", "pack", "int8")
    assert PACK_PAD == JPACK_PAD == 8


def test_exchange_keys_roundtrip_equals_jax():
    """The stage-3 key list through each mode: the same keys back, the
    same ``wire_bytes`` as JAX's (exact), and the multi-shard form raises
    naming its queue item."""
    rng = np.random.default_rng(4)
    keys = np.sort(np.unique(rng.integers(0, 50_000, 300))).astype(np.int32)
    keys = np.pad(keys, (0, 100), constant_values=SENTINEL)
    for mode in SPARSE_COMMS:
        comm, jcomm = SparseComm(mode), JSparseComm(mode)
        out = comm.exchange_keys(keys)
        np.testing.assert_array_equal(out, keys)
        np.testing.assert_array_equal(out, jcomm.exchange_keys(keys))
        assert out.dtype == keys.dtype
        assert comm.wire_bytes == jcomm.wire_bytes > 0
    assert SparseComm("pack").wire_bytes == 0
    with pytest.raises(NotImplementedError, match="item 6"):
        SparseComm("pack").exchange_keys(keys, num_slices=2)


def test_off_mode_counts_but_never_transforms():
    comm = SparseComm("off")
    keys = np.array([4, 1, 3], np.int64)  # off never requires sortedness
    assert comm.exchange_keys(keys) is keys
    assert comm.wire_bytes == keys.nbytes
    assert comm.pad_rows(5, 64) == 64
    idx = np.arange(5, dtype=np.int32)
    assert comm.pack_index(idx, 1000).dtype == np.int32
    assert comm.counters() == {"wire_bytes": float(keys.nbytes),
                               "idx_bytes": 20.0}


def test_pads_and_index_dtypes_equal_jax():
    for mode in SPARSE_COMMS:
        comm, jcomm = SparseComm(mode), JSparseComm(mode)
        for n in (0, 1, 5, 8, 9, 64, 65, 1000):
            for bucket in (4, 8, 64):
                assert comm.pad_rows(n, bucket) == jcomm.pad_rows(n, bucket)
                for r in (1, 3, 8):
                    assert comm.pad_chunks(n, bucket, r) == \
                        jcomm.pad_chunks(n, bucket, r)
        for max_val in (200, 60_000, 7_000_000):
            idx = np.arange(7, dtype=np.int32)
            a, b = comm.pack_index(idx, max_val), jcomm.pack_index(idx, max_val)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert comm.counters() == jcomm.counters()


def test_pack_pad_narrows_to_occupied_prefix():
    comm = SparseComm("pack")
    assert comm.pad_rows(5, 64) == PACK_PAD
    assert comm.pad_rows(9, 64) == 2 * PACK_PAD
    assert comm.pad_rows(0, 64) == 0
    assert comm.pack_index(np.arange(5, dtype=np.int32), 200).dtype == np.uint8


def test_int8_staging_equals_jax_in_place():
    """The staged rows quantize in place to JAX's bytes, whole-buffer and
    chunk-burst forms, from numpy arrays and from CPU tensors; the payload
    bytes agree."""
    rng = np.random.default_rng(6)
    rows = rng.standard_normal((40, 16)).astype(np.float32)
    rows[-5:] = 0.0  # sentinel slots
    accum = rng.random(40).astype(np.float32)
    hot = np.array([0, 3, 7, 20], np.int64)
    comm, jcomm = SparseComm("int8"), JSparseComm("int8")
    a, b = rows.copy(), rows.copy()
    t = torch.from_numpy(rows.copy())
    assert comm.stage_payload(a, accum) == jcomm.stage_payload(b, accum)
    assert comm.stage_payload(t, accum) == jcomm.stage_payload(rows.copy(), accum)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.numpy(), b)
    a, b = rows.copy(), rows.copy()
    assert comm.stage_chunk_payload(a, accum, hot) == \
        jcomm.stage_chunk_payload(b, accum, hot)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[hot], rows[hot])  # the accessed rows moved
    np.testing.assert_array_equal(np.delete(a, hot, 0), np.delete(rows, hot, 0))


def test_int8_writeback_sync_and_error_feedback():
    """hot_threshold=1: every row syncs. The master gets the dequantized
    delta, the residual keeps the quantization error, the adagrad state
    lands absolutely; all equal to JAX's object on the same inputs."""
    rng = np.random.default_rng(0)
    master = rng.standard_normal((16, 4)).astype(np.float32)
    base = master.copy()
    jmaster = master.copy()
    m_accum, jm_accum = np.zeros(16, np.float32), np.zeros(16, np.float32)
    comm = SparseComm("int8", hot_threshold=1)
    jcomm = JSparseComm("int8", hot_threshold=1)
    keys = np.array([2, 5, 11])
    rows = (base[keys] + rng.standard_normal((3, 4))).astype(np.float32)
    accum = np.array([1.0, 2.0, 3.0], np.float32)
    nbytes = comm.writeback(keys, rows, accum, master, m_accum)
    assert nbytes == jcomm.writeback(keys, rows, accum, jmaster, jm_accum) == 36
    assert comm.rows_synced == 3 and comm.rows_deferred == 0
    payload = rows - base[keys]
    q, scales, err = tc.quantize_rows_np(payload)
    np.testing.assert_array_equal(master[keys],
                                  base[keys] + tc.dequantize_rows_np(q, scales))
    np.testing.assert_array_equal(comm.residual_rows(keys, 4), err)
    np.testing.assert_array_equal(m_accum[keys], accum)
    update2 = rng.standard_normal((3, 4)).astype(np.float32)
    rows2 = master[keys] + update2
    comm.writeback(keys, rows2, accum, master, m_accum)
    jcomm.writeback(keys, rows2, accum, jmaster, jm_accum)
    target = base[keys] + payload + update2
    np.testing.assert_allclose(target - master[keys],
                               comm.residual_rows(keys, 4), atol=1e-6)
    np.testing.assert_array_equal(master, jmaster)
    np.testing.assert_array_equal(comm.residual_rows(keys, 4),
                                  jcomm.residual_rows(keys, 4))
    assert comm.counters() == jcomm.counters()


def test_int8_writeback_deferral_banks_whole_payload():
    """Cold rows defer: the master moves nothing and the residual banks
    the whole payload; the RNG draws decide as JAX's do (same seed, same
    call order: the same rows sync)."""
    rng = np.random.default_rng(1)
    master = rng.standard_normal((32, 4)).astype(np.float32)
    base, jmaster = master.copy(), master.copy()
    m_accum, jm_accum = np.zeros(32, np.float32), np.zeros(32, np.float32)
    kw = dict(hot_threshold=10 ** 6, min_sync_p=0.0, seed=3)
    comm, jcomm = SparseComm("int8", **kw), JSparseComm("int8", **kw)
    keys = np.arange(8)
    rows = (base[keys] + 1.0).astype(np.float32)
    accum = np.ones(8, np.float32)
    comm.writeback(keys, rows, accum, master, m_accum)
    jcomm.writeback(keys, rows, accum, jmaster, jm_accum)
    assert comm.rows_synced + comm.rows_deferred == 8
    deferred = np.asarray(master[keys] == base[keys]).all(axis=1)
    assert int(deferred.sum()) == comm.rows_deferred
    np.testing.assert_array_equal(comm.residual_rows(keys, 4)[deferred],
                                  (rows - base[keys])[deferred])
    np.testing.assert_array_equal(m_accum[keys[deferred]], 0.0)
    np.testing.assert_array_equal(master, jmaster)
    # a mid-frequency stream: some rows sync, some defer, as in JAX
    kw = dict(hot_threshold=4, min_sync_p=0.1, seed=9)
    comm, jcomm = SparseComm("int8", **kw), JSparseComm("int8", **kw)
    for step in range(6):
        ks = np.unique(rng.integers(0, 32, 12))
        r = (master[ks] + rng.standard_normal((ks.size, 4))).astype(np.float32)
        a = rng.random(ks.size).astype(np.float32)
        comm.writeback(ks, r, a, master, m_accum)
        jcomm.writeback(ks, r, a, jmaster, jm_accum)
    assert comm.rows_deferred > 0 and comm.rows_synced > 0
    assert comm.counters() == jcomm.counters()
    np.testing.assert_array_equal(master, jmaster)
    np.testing.assert_array_equal(m_accum, jm_accum)


def test_int8_state_across_many_chunks_equals_jax():
    """Keys spread over more than two of the port's state blocks (1,024
    chunks of 64 rows each), with repeats across calls: the masters, the
    adagrad state, every residual row (untouched keys read zeros) and the
    counters, chunk count included, equal JAX's bit for bit."""
    rng = np.random.default_rng(12)
    rows_total, dim = 3000 * 64, 8
    master = rng.standard_normal((rows_total, dim)).astype(np.float32)
    jmaster = master.copy()
    m_accum, jm_accum = np.zeros(rows_total, np.float32), np.zeros(rows_total, np.float32)
    kw = dict(hot_threshold=2, min_sync_p=0.2, seed=5)
    comm, jcomm = SparseComm("int8", **kw), JSparseComm("int8", **kw)
    for step in range(3):
        ks = np.unique(rng.integers(0, rows_total, 2500))
        r = (master[ks] + 0.1 * rng.standard_normal((ks.size, dim))).astype(np.float32)
        a = rng.random(ks.size).astype(np.float32)
        assert comm.writeback(ks, r, a, master, m_accum) == \
            jcomm.writeback(ks, r, a, jmaster, jm_accum)
    np.testing.assert_array_equal(master, jmaster)
    np.testing.assert_array_equal(m_accum, jm_accum)
    probe = np.arange(0, rows_total, 7)
    np.testing.assert_array_equal(comm.residual_rows(probe, dim),
                                  jcomm.residual_rows(probe, dim))
    assert comm.counters() == jcomm.counters()
    assert comm.counters()["comm_state_chunks"] > 2 * 1024


def test_int8_never_selectable_silently():
    comm = SparseComm("int8")
    assert comm.lossy and "comm_rows_synced" in comm.counters()
    assert not SparseComm("pack").lossy and not SparseComm("off").lossy


# ---------------------------------------------------------------------------
# pipeline: pack replays off bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def init_state():
    return clone_state(Session.from_arch(ARCH, device="cpu", **KW).state)


def run_port(init, tier, mode, *, async_on=False, lookahead=1, **store_kw):
    """``STEPS`` steps of the port through ``tier`` with a fresh
    ``SparseComm(mode)``; returns (state, stats, store)."""
    sess = Session.from_arch(ARCH, device="cpu", prefetch_ahead=lookahead, **KW)
    sess.state = clone_state(init)
    wl = sess.workload
    cls = {"host": HostStore, "cached": CachedStore}[tier]
    store = cls(wl.engine, n_micro=wl.n_micro, comm=SparseComm(mode), **store_kw)
    driver = sess.strategy.build_driver(
        sess.fns, resolve_stream(wl, sess.seed), wl, store=store,
        async_stages=async_on)
    state, stats = driver.run(sess._take_state(), STEPS)
    return state, stats, store


def _same(a, b):
    return torch.equal(a.table.rows, b.table.rows) and \
        torch.equal(a.table.accum, b.table.accum)


@pytest.mark.parametrize("tier", ["host", "cached"])
@pytest.mark.parametrize("async_on", [False, True])
def test_pack_bit_exact(init_state, tier, async_on):
    """``pack`` against ``off``, bit for bit: losses, rows, adagrad state;
    the wire ledger ran in both and pack never exceeds raw."""
    state_o, stats_o, store_o = run_port(init_state, tier, "off", async_on=async_on)
    state_p, stats_p, store_p = run_port(init_state, tier, "pack", async_on=async_on)
    assert stats_p.losses == stats_o.losses
    assert _same(state_p, state_o)
    assert store_p.sparse_comm == "pack"
    assert stats_p.sparse_comm == "pack" and stats_o.sparse_comm == "off"
    m_o, m_p = store_o.metrics(), store_p.metrics()
    assert m_o["wire_bytes"] > 0 and m_p["wire_bytes"] > 0
    assert m_p["wire_bytes"] <= m_o["wire_bytes"]


def test_pack_shrinks_cached_staging_bytes(init_state):
    _, _, store_o = run_port(init_state, "cached", "off")
    _, _, store_p = run_port(init_state, "cached", "pack")
    m_o, m_p = store_o.metrics(), store_p.metrics()
    assert m_p["h2d_bytes"] < m_o["h2d_bytes"], (m_o, m_p)
    assert m_p["idx_bytes"] < m_o["idx_bytes"], (m_o, m_p)


def test_pack_bit_exact_on_eviction_path(init_state):
    """Eviction write-back stays full precision: a small pack cache still
    replays off, bit for bit, with the executor on."""
    kw = dict(capacity=32, miss_bucket=8, chunk_rows=1)
    state_o, stats_o, _ = run_port(init_state, "cached", "off", **kw)
    state_p, stats_p, store = run_port(init_state, "cached", "pack",
                                       async_on=True, **kw)
    assert store.evictions > 0
    assert stats_p.losses == stats_o.losses
    assert _same(state_p, state_o)


def test_int8_loss_parity_and_ledger(init_state):
    """int8 is approximate but close (within 0.05 of off, the JAX test's
    bound), its ledger runs, and it stages fewer bytes; the executor does
    not change its trajectory (bit for bit)."""
    _, stats_o, store_o = run_port(init_state, "host", "off")
    state_q, stats_q, store = run_port(init_state, "host", "int8")
    assert store.sparse_comm == "int8" and stats_q.sparse_comm == "int8"
    dev = max(abs(a - b) for a, b in zip(stats_q.losses, stats_o.losses))
    assert 0 <= dev < 0.05, (dev, stats_q.losses, stats_o.losses)
    m = store.metrics()
    assert m["comm_rows_synced"] + m["comm_rows_deferred"] > 0
    assert stats_q.summary()["comm_rows_synced"] == m["comm_rows_synced"]
    assert store.h2d_bytes < store_o.h2d_bytes
    state_a, stats_a, _ = run_port(init_state, "host", "int8", async_on=True)
    assert stats_a.losses == stats_q.losses and _same(state_a, state_q)


def test_build_store_and_session_take_every_mode():
    sess = Session.from_arch(ARCH, device="cpu", sparse_comm="pack", **KW)
    assert sess.workload.npcfg.sparse_comm == "pack"
    eng = sess.workload.engine
    for mode in SPARSE_COMMS:
        assert build_store("cached", eng, sparse_comm=mode).sparse_comm == mode
    rep = Session.from_arch(ARCH, device="cpu", store="host",
                            sparse_comm="int8", **KW).train(2)
    assert rep.summary["sparse_comm"] == "int8"
    assert rep.summary["comm_rows_synced"] + rep.summary["comm_rows_deferred"] > 0


def test_frozen_view_surfaces_comm_counters_and_serves_exactly(init_state):
    sess = Session.from_arch(ARCH, device="cpu", store="cached", **KW)
    sess.state = clone_state(init_state)
    store = CachedStore.from_device_table(sess.workload.engine,
                                          sess.state.table, capacity=64,
                                          comm=SparseComm("pack"))
    store.owns_master = True
    view = FrozenStoreView(store)
    assert view.sparse_comm == "pack"
    m = view.metrics()
    assert "wire_bytes" in m and "idx_bytes" in m and m["read_only"] == 1.0
    rep = sess.serve_embeddings(num_requests=48, max_batch=8, head="dlrm",
                                sparse_comm="pack", check_exact=True)
    assert rep.summary["sparse_comm"] == "pack" and rep.summary["exact"] == 1


# ---------------------------------------------------------------------------
# against the JAX package: pack and int8 trajectories and ledgers
# ---------------------------------------------------------------------------


def _np(x):
    return np.array(x, copy=True)  # the JAX run donates its input buffers


def _jax_run(tier, mode):
    js = JSession.from_arch(ARCH, store="device", **KW)
    init = jax.tree.map(_np, js.state)
    spec, fns = js.workload.spec, js.fns
    cls = {"host": JHostStore, "cached": JCachedStore}[tier]
    store = cls(spec, fns, comm=JSparseComm(mode))
    driver = js.strategy.build_driver(
        fns, jresolve_stream(js.workload, js.data_seed), js.workload,
        store=store)
    state, stats = driver.run(js.state, STEPS)
    return init, stats, jax.tree.map(_np, state.table)


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@pytest.mark.parametrize("tier,mode,async_on", [
    ("host", "int8", False), ("cached", "int8", True),
    ("host", "pack", True), ("cached", "pack", False)])
def test_modes_match_jax(tier, mode, async_on):
    """The port from the JAX session's initial state against JAX's run of
    the same mode: losses and master within 1e-5, every ledger counter
    both keep exactly equal (int8's sync decisions included)."""
    init, jstats, jtable = _jax_run(tier, mode)
    state, stats, _ = run_port(train_state_from_jax(init, "cpu"), tier, mode,
                               async_on=async_on)
    np.testing.assert_allclose(stats.losses, jstats.losses, rtol=0, atol=1e-5)
    assert _max_diff(state.table.rows, jtable.rows) <= 1e-5
    assert _max_diff(state.table.accum, jtable.accum) <= 1e-5
    jm, pm = jstats.store_metrics, stats.store_metrics
    for k in LEDGER:
        if k in jm:
            assert pm[k] == jm[k], k
    assert set(jm) & set(LEDGER) <= set(pm)
    if mode == "int8":
        assert pm["comm_rows_deferred"] > 0 and pm["comm_rows_synced"] > 0
