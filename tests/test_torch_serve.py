"""The serving slice as a whole: the port against the JAX package.

The JAX package's fresh-init DLRM params and master table at the reduced
``dlrm-ctr`` config are carried into the port (``repro_torch.convert``),
and both packages serve the same synthetic requests, closed loop,
``max_batch=8``:

- the ``embedding`` head is bit-equal per request;
- the ``dlrm`` head holds to ``rtol=1e-5, atol=1e-6``: f32 matmuls sum in
  another order on XLA:CPU than in torch on the CPU;
- the port's own ``check_exact`` gives ``exact == 1``;
- request streams are byte-equal.

On ``dlrm-cached``, from the JAX session's weights, each tier (device,
host, cached) serves the JAX tier's rows bit for bit, with the same cache
counters, and serves its own trained master exactly; the cached tier
serves hits with read-path metrics; ``pending_keys`` equals JAX's; the
router hands every window's read horizon to the cached tier's admission.

Also: the frozen view rejects every mutation, the default device raises
without a GPU, and no module of the port imports jax or ``repro``.
"""
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.api import Session as JSession
from repro.configs.registry import get_arch as jget_arch
from repro.core.embedding import init_table_state as jinit_table
from repro.core.embedding.table import make_mega_table_spec as jmake_spec
from repro.models.dlrm import init_dlrm_params
from repro.serve import synthetic_requests as jrequests
from repro_torch.api import Session
from repro_torch.configs.base import NestPipeConfig
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import dlrm_params_from_jax, table_from_jax
from repro_torch.core.embedding.table import make_mega_table_spec as tmake_spec
from repro_torch.core.store import DeviceStore
from repro_torch.kernels import dispatch
from repro_torch.kernels import embedding_gather as eg
from repro_torch.serve import (
    COMMIT_METRIC_KEYS,
    FrozenStoreView,
    ReadOnlyStoreError,
    synthetic_requests,
)

ARCH = "dlrm-ctr"  # reduced: 3 tables, 5 feature slots, dim 16
N_REQ, MAX_BATCH = 24, 8


@pytest.fixture(scope="module")
def jax_weights():
    """What an untrained JAX session serves (seed 0): params from
    PRNGKey(0), the table from PRNGKey(1)."""
    cfg = jget_arch(ARCH).reduced
    params = init_dlrm_params(jax.random.PRNGKey(0), cfg)
    table = jinit_table(jax.random.PRNGKey(1),
                        jmake_spec(cfg.tables, num_shards=1), None, ("model",))
    return (jax.tree.map(np.asarray, params),
            (np.asarray(table.rows), np.asarray(table.accum)))


def _port_session(jax_weights, **kw):
    params, (rows, accum) = jax_weights
    sess = Session.from_arch(ARCH, reduced=True, device="cpu", **kw)
    sess.ingest(dlrm_params_from_jax(params), table_from_jax(rows, accum, "cpu"))
    return sess


def _jax_serve(head):
    sess = JSession.from_arch(ARCH, reduced=True, global_batch=MAX_BATCH,
                              seq_len=8, store="device")
    return sess.serve_embeddings(num_requests=N_REQ, max_batch=MAX_BATCH,
                                 head=head)


@pytest.mark.parametrize("head", ["embedding", "dlrm"])
def test_served_results_match_jax(jax_weights, head):
    want = _jax_serve(head)
    got = _port_session(jax_weights).serve_embeddings(
        num_requests=N_REQ, max_batch=MAX_BATCH, head=head, check_exact=True)
    assert got.summary["exact"] == 1 and got.summary["max_abs_diff"] == 0.0
    assert got.results.shape == want.results.shape
    assert got.results.dtype == want.results.dtype == np.float32
    if head == "embedding":
        np.testing.assert_array_equal(got.results, want.results)
    else:
        np.testing.assert_allclose(got.results, want.results, rtol=1e-5, atol=1e-6)
    for k in ("requests_done", "windows", "window_fill", "read_only", "reads"):
        assert got.summary[k] == want.summary[k], k
    assert got.summary["store"] == want.summary["store"] == "frozen-device"


def test_request_streams_byte_equal():
    jcfg, tcfg = jget_arch(ARCH).config, tget_arch(ARCH).config
    jwl = types.SimpleNamespace(bundle=types.SimpleNamespace(cfg=jcfg),
                                spec=jmake_spec(jcfg.tables, num_shards=1))
    twl = types.SimpleNamespace(cfg=tcfg, spec=tmake_spec(tcfg.tables, num_shards=1))
    for n, seed in ((40, 0), (600, 3)):
        for (tk, td), (jk, jd) in zip(synthetic_requests(twl, n, seed=seed),
                                      jrequests(jwl, n, seed=seed)):
            assert tk.tobytes() == jk.tobytes() and td.tobytes() == jd.tobytes()


def test_open_loop_matches_closed_loop(jax_weights):
    sess = _port_session(jax_weights)
    closed = sess.serve_embeddings(num_requests=20, max_batch=MAX_BATCH)
    opened = sess.serve_embeddings(num_requests=20, max_batch=MAX_BATCH,
                                   qps=1e5, check_exact=True)
    assert opened.summary["exact"] == 1
    np.testing.assert_array_equal(opened.results, closed.results)


def test_fresh_init_serves_exactly_and_never_launches_on_cpu(monkeypatch):
    calls = []
    real = dispatch.gather_rows
    monkeypatch.setattr(dispatch, "gather_rows",
                        lambda r, i: calls.append(len(i)) or real(r, i))
    before = eg.launches
    rep = Session.from_arch(ARCH, reduced=True, device="cpu", seed=4) \
        .serve_embeddings(num_requests=20, max_batch=MAX_BATCH, head="dlrm",
                          check_exact=True)
    assert rep.summary["exact"] == 1 and np.isfinite(rep.results).all()
    windows, chunks = int(rep.summary["windows"]), -(-20 // MAX_BATCH)
    assert len(calls) == 4 * windows + 3 * chunks  # the main path's gathers
    assert eg.launches == before


def test_routing_overflow_fails_the_window():
    sess = Session.from_arch(ARCH, reduced=True, device="cpu", bucket_slack=0.05)
    with pytest.raises(RuntimeError, match="overflowed"):
        sess.serve_embeddings(num_requests=16, max_batch=16)


def test_frozen_view_rejects_all_mutations(jax_weights):
    sess = _port_session(jax_weights)
    _, table = sess.weights()
    wl = sess.workload
    store = DeviceStore(wl.engine)
    with pytest.raises(ValueError, match="INGESTED"):
        FrozenStoreView(store)
    store.ingest(table)
    view = FrozenStoreView(store)
    for op, args in (("commit", (None,)), ("ingest", (table,)), ("release", ()),
                     ("export_table", ()), ("scatter_host", (None, None, None))):
        with pytest.raises(ReadOnlyStoreError):
            getattr(view, op)(*args)
    view.flush()
    assert store.export_table() is table  # the master is untouched
    keys = np.asarray(synthetic_requests(wl, 8)[0][0])[None, None]
    view.retrieve(view.plan(keys))
    m = view.metrics()
    assert m["read_only"] == 1.0 and m["reads"] == 1.0
    assert not set(COMMIT_METRIC_KEYS) & set(m)


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session.from_arch(ARCH, reduced=True)


def test_unported_store_tiers_raise():
    """The host and cached tiers serve, and so do their sparse-comm modes,
    ported since: ``pack`` exactly (``exact`` 1, from the config and from
    ``serve_embeddings(sparse_comm=...)``), ``int8`` approximately (its
    staged rows are quantized), each labelled. A mode outside the three
    still raises."""
    sess = Session.from_arch(ARCH, reduced=True, device="cpu")
    for tier in ("host", "cached"):
        rep = sess.serve_embeddings(num_requests=8, max_batch=8, store=tier,
                                    check_exact=True)
        assert rep.summary["exact"] == 1 and rep.summary["store"] == f"frozen-{tier}"
        for mode in ("pack", "int8"):
            packed = Session.from_arch(ARCH, reduced=True, device="cpu",
                                       npcfg=NestPipeConfig(sparse_comm=mode))
            for rep in (packed.serve_embeddings(num_requests=8, max_batch=8,
                                                store=tier, check_exact=True),
                        sess.serve_embeddings(num_requests=8, max_batch=8,
                                              store=tier, sparse_comm=mode,
                                              check_exact=True)):
                assert rep.summary["sparse_comm"] == mode
                assert rep.summary["exact"] == (mode == "pack")
                assert rep.summary["max_abs_diff"] < 1e-3
        with pytest.raises(ValueError, match="sparse_comm"):
            sess.serve_embeddings(num_requests=8, max_batch=8, store=tier,
                                  sparse_comm="zstd")


# ---------------------------------------------------------------------------
# the host and cached tiers (tests/test_serve.py mirrored on dlrm-cached)
# ---------------------------------------------------------------------------

CACHED_ARCH = "dlrm-cached"  # steep zipf: the cache's admission path
TIERS = ("device", "host", "cached")


def _cached_pair(store):
    """A JAX session on ``dlrm-cached`` and a port session holding its
    initial weights (dense params and master table)."""
    js = JSession.from_arch(CACHED_ARCH, reduced=True, global_batch=16, seq_len=8,
                            n_micro=4, store=store, lr=1e-2, data_seed=0)
    state = jax.tree.map(lambda x: np.array(x, copy=True), js.state)
    sess = Session.from_arch(CACHED_ARCH, reduced=True, global_batch=16, n_micro=4,
                             store=store, lr=1e-2, device="cpu")
    sess.ingest(dlrm_params_from_jax(state.dense),
                table_from_jax(state.table.rows, state.table.accum, "cpu"))
    return js, sess


@pytest.mark.parametrize("store", TIERS)
def test_served_rows_bit_exact_per_tier(store):
    """Each tier serves the JAX tier's rows bit for bit from the same
    weights, and after training serves its own master exactly."""
    js, sess = _cached_pair(store)
    want = js.serve_embeddings(num_requests=40, max_batch=8, store=store)
    got = sess.serve_embeddings(num_requests=40, max_batch=8, store=store,
                                check_exact=True)
    np.testing.assert_array_equal(got.results, want.results)
    assert got.summary["exact"] == 1 and got.summary["store"] == f"frozen-{store}"
    for k in ("windows", "requests_done", "reads", "cache_hits", "cache_misses",
              "h2d_bytes", "h2d_bursts"):
        assert got.summary.get(k) == want.summary.get(k), k
    sess.train(2)
    rep = sess.serve_embeddings(num_requests=40, max_batch=8, store=store,
                                check_exact=True)
    assert rep.summary["exact"] == 1 and rep.summary["max_abs_diff"] == 0.0
    assert rep.results.shape[0] == 40 and rep.summary["requests_done"] == 40.0


def test_cached_tier_serves_hits_and_clean_metrics():
    _, sess = _cached_pair("cached")
    sess.train(2)
    s = sess.serve_embeddings(num_requests=64, max_batch=16).summary
    # the read horizon admits the keys the queue will ask for again
    assert s["cache_hits"] > 0 and s["cache_hit_rate"] > 0
    assert s["read_only"] == 1.0 and s["reads"] == s["windows"]
    for k in COMMIT_METRIC_KEYS:
        assert k not in s, (k, sorted(s))
    assert "plan_ms" in s and "retrieve_ms" in s


def test_pending_keys_equal_jax():
    from repro.serve.batcher import WindowBatcher as JBatcher
    from repro_torch.serve.batcher import WindowBatcher

    rng = np.random.default_rng(7)
    mine, theirs = WindowBatcher(4, 2.0), JBatcher(4, 2.0)
    assert mine.pending_keys().size == theirs.pending_keys().size == 0
    for step in range(6):
        for _ in range(3):
            keys = rng.integers(0, 500, size=6).astype(np.int32)
            mine.submit(keys)
            theirs.submit(keys)
        got, want = mine.pending_keys(), theirs.pending_keys()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if step % 2:
            mine.next_window(force=True)
            theirs.next_window(force=True)


def test_read_horizon_reaches_the_cached_tiers_admission(monkeypatch):
    """Before every window the router hands the cached tier the sorted
    union of that window's keys and every queued request's."""
    from repro_torch.core.store import CachedStore
    from repro_torch.serve import ServeRouter

    seen, windows = [], []
    real_allow = CachedStore.set_admission_allow
    real_dispatch = ServeRouter._dispatch

    def allow(self, keys):
        seen.append(None if keys is None else np.array(keys, copy=True))
        return real_allow(self, keys)

    def dispatch_(self, window):
        windows.append((np.unique(window.keys), self.batcher.pending_keys()))
        return real_dispatch(self, window)

    monkeypatch.setattr(CachedStore, "set_admission_allow", allow)
    monkeypatch.setattr(ServeRouter, "_dispatch", dispatch_)
    _, sess = _cached_pair("cached")
    rep = sess.serve_embeddings(num_requests=24, max_batch=8, check_exact=True)
    assert rep.summary["exact"] == 1
    assert len(seen) == len(windows) == rep.summary["windows"]
    for got, (mine, queued) in zip(seen, windows):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.union1d(mine, queued))


def test_cli_serves_on_cpu(capsys):
    from repro_torch.launch.serve import serve

    out = serve(["--arch", ARCH, "--reduced", "--device", "cpu", "--head", "dlrm",
                 "--requests", "12", "--max-batch", "4"])
    assert out.shape == (12,)
    assert '"exact": 1' in capsys.readouterr().out


def test_port_imports_neither_jax_nor_repro():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "assert len(mods) > 40, mods\n"
        "assert {'repro_torch.models.hstu', 'repro_torch.models.layers',\n"
        "        'repro_torch.kernels.hstu_attention', 'repro_torch.kernels.flash_attention',\n"
        "        'repro_torch.models.transformer', 'repro_torch.models.zoo',\n"
        "        'repro_torch.configs.stablelm_12b', 'repro_torch.configs.stablelm_3b',\n"
        "        'repro_torch.configs.yi_34b',\n"
        "        'repro_torch.configs.nemotron_4_340b',\n"
        "        'repro_torch.core.store.host', 'repro_torch.core.store.cached',\n"
        "        'repro_torch.core.store.policy', 'repro_torch.core.store.comm',\n"
        "        } <= set(mods), mods\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
