"""The cached tier's policy seam (``core/store/policy.py``): the port
against the JAX package (``tests/test_cache_policies.py`` mirrored,
without its async-executor and sharded cases, which are not ported).

- Resolution (argument > ``$REPRO_CACHE_POLICY`` > ``"freq"``), the
  factory, each policy's displacement rule, the oracle's horizon and the
  store's rolling horizon: exact.
- ``admit_mask``, ``admit_order``, ``victim_order`` and ``displace`` equal
  JAX's, element for element, on seeded chunk and count sequences.
- Every policy at every chunk size in {1, 3, 4, 8}, under eviction
  pressure (a 32-row cache), replays the port's host tier bit for bit:
  losses, master rows and adagrad state (``torch.equal``).
- Each policy's counters equal the JAX cached tier's exactly on the same
  workload (reduced ``dlrm-ctr``, 5 steps; losses within 1e-5).
- Burst accounting: ``h2d_bursts`` equals the misses at ``chunk_rows=1``
  and stays below them at a coarser chunk.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _hypothesis_compat import given, settings, st
from repro.core.store import policy as jpolicy
from repro_torch.core.embedding.routing import SENTINEL
from repro_torch.core.store import CACHE_POLICIES, FetchPlan, make_cache_policy, \
    resolve_cache_policy
from repro_torch.core.store import policy as tpolicy
from repro_torch.core.store.policy import FreqPolicy, LfuPolicy, LruPolicy, \
    OraclePolicy
from test_torch_store import COUNTERS, _jax_run, _max_diff, _port_run_from, \
    _session, run_port


@pytest.fixture(autouse=True)
def _no_policy_env(monkeypatch):
    for var in ("REPRO_STORE", "REPRO_CACHE_POLICY", "REPRO_SPARSE_COMM"):
        monkeypatch.delenv(var, raising=False)


# ---------------------------------------------------------------------------
# resolution: arg > $REPRO_CACHE_POLICY > "freq"
# ---------------------------------------------------------------------------


def test_resolve_cache_policy_precedence(monkeypatch):
    assert resolve_cache_policy(None) == "freq"
    assert resolve_cache_policy("auto") == "freq"
    assert resolve_cache_policy("lru") == "lru"
    monkeypatch.setenv("REPRO_CACHE_POLICY", "oracle")
    assert resolve_cache_policy("auto") == "oracle"  # env fills the auto hole
    assert resolve_cache_policy("lfu") == "lfu"  # explicit arg wins
    with pytest.raises(ValueError, match="cache_policy"):
        resolve_cache_policy("sideways")
    monkeypatch.setenv("REPRO_CACHE_POLICY", "sideways")
    with pytest.raises(ValueError, match="cache_policy"):
        resolve_cache_policy("auto")


def test_env_policy_reaches_the_store(monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_POLICY", "lru")
    sess = _session(store="cached")
    from repro_torch.api.strategies import build_workload_store

    assert build_workload_store(sess.workload)._policy.name == "lru"
    assert tuple(CACHE_POLICIES) == tuple(jpolicy.CACHE_POLICIES)


def test_make_cache_policy_factory():
    for name in CACHE_POLICIES:
        assert make_cache_policy(name).name == name


# ---------------------------------------------------------------------------
# policy unit semantics
# ---------------------------------------------------------------------------


def _touched(policy, *windows):
    for w in windows:
        chunks = np.asarray(sorted(set(w)), np.int64)
        counts = np.asarray([w.count(c) for c in chunks.tolist()], np.int64)
        policy.touch(chunks, counts)
    return policy


def test_freq_displaces_only_strictly_hotter():
    p = _touched(FreqPolicy(), [1, 1, 1], [2], [3, 3])
    np.testing.assert_array_equal(
        p.displace(np.array([1, 2]), np.array([2, 3])), [True, False])
    p2 = _touched(FreqPolicy(admit_threshold=2), [1, 2, 2])
    np.testing.assert_array_equal(p2.admit_mask(np.array([1, 2])), [False, True])


def test_lfu_ties_go_to_the_candidate():
    p = _touched(LfuPolicy(), [1, 2])
    np.testing.assert_array_equal(p.displace(np.array([1]), np.array([2])), [True])
    assert p.admit_mask(np.array([7, 8])).all()


def test_lru_victims_order_by_recency_not_count():
    p = _touched(LruPolicy(), [1, 1, 1], [2])  # 1 hot but stale, 2 recent
    assert p.victim_order(np.array([1, 2]))[0] == 0
    assert p.displace(np.array([9]), np.array([1])).all()


def test_oracle_horizon_drives_eviction():
    p = _touched(OraclePolicy(), [1, 2], [2, 3])
    p.set_horizon({2: 2, 3: 1})
    assert p.admit_mask(np.array([5, 6])).all()
    assert p.victim_order(np.array([1, 2, 3]))[0] == 0
    np.testing.assert_array_equal(
        p.displace(np.array([9, 3, 3]), np.array([1, 2, 3])), [True, False, False])
    p.reset()
    assert p._horizon == {} and p.state_chunks() == 0


@pytest.mark.parametrize("name", CACHE_POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_answers_equal_jax(name, seed):
    """The four questions, element for element, on seeded windows of
    chunks with repeats (ties included) and a seeded horizon."""
    rng = np.random.default_rng(seed)
    mine = tpolicy.make_cache_policy(name, admit_threshold=2)
    theirs = jpolicy.make_cache_policy(name, admit_threshold=2)
    for _ in range(6):
        chunks = np.unique(rng.integers(0, 40, size=rng.integers(1, 25)))
        counts = rng.integers(1, 4, size=chunks.size)
        horizon = {int(c): int(n) for c, n in
                   zip(rng.integers(0, 40, 10), rng.integers(1, 3, 10))}
        for p in (mine, theirs):
            p.touch(chunks, counts)
            p.set_horizon(horizon)
        probe = rng.permutation(48)[:int(rng.integers(1, 48))].astype(np.int64)
        other = rng.permutation(48)[:probe.size].astype(np.int64)
        for q in ("admit_mask", "admit_order", "victim_order"):
            np.testing.assert_array_equal(getattr(mine, q)(probe),
                                          getattr(theirs, q)(probe), err_msg=q)
        np.testing.assert_array_equal(mine.displace(probe, other),
                                      theirs.displace(probe, other))
        assert mine.state_chunks() == theirs.state_chunks()


def test_store_publishes_lookahead_horizon():
    """The rolling horizon is the union of the last ``horizon_windows``
    retrieved windows with per-window occurrence counts."""
    sess = _session()
    from repro_torch.core.store import CachedStore

    store = CachedStore.from_device_table(sess.workload.engine, sess.state.table,
                                          policy="oracle", horizon_windows=2)
    R = store.chunk_rows

    def plan_for(rows):
        keys = np.full((16,), SENTINEL, np.int32)
        keys[:len(rows)] = rows
        return FetchPlan(None, keys)

    store.retrieve(plan_for([0, 1, 2 * R]))        # chunks {0, 2}
    store.retrieve(plan_for([1, 3 * R]))           # chunks {0, 3}
    assert store._policy._horizon == {0: 2, 2: 1, 3: 1}
    store.retrieve(plan_for([5 * R]))              # chunks {5}: window 1 ages out
    assert store._policy._horizon == {0: 1, 3: 1, 5: 1}


# ---------------------------------------------------------------------------
# every policy x chunk grain: one trajectory
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_truth():
    state, stats, _ = run_port("host")
    return state, stats.losses


@pytest.mark.parametrize("chunk_rows", [1, 3, 4, 8])
@pytest.mark.parametrize("policy", CACHE_POLICIES)
def test_policies_replay_host_tier_bit_for_bit(host_truth, policy, chunk_rows):
    state_h, losses_h = host_truth
    state, stats, store = run_port("cached", capacity=32, miss_bucket=8,
                                   chunk_rows=chunk_rows, policy=policy)
    assert store._policy.name == policy
    assert stats.losses == losses_h
    assert torch.equal(state.table.rows, state_h.table.rows)
    assert torch.equal(state.table.accum, state_h.table.accum)


@settings(max_examples=4, deadline=None)
@given(policy=st.sampled_from(CACHE_POLICIES), chunk_rows=st.sampled_from([1, 3, 4, 8]),
       capacity=st.sampled_from([8, 24, 64]))
def test_policies_replay_host_tier_at_any_capacity(host_truth, policy, chunk_rows,
                                                   capacity):
    state_h, losses_h = host_truth
    state, stats, _ = run_port("cached", capacity=capacity, miss_bucket=8,
                               chunk_rows=chunk_rows, policy=policy)
    assert stats.losses == losses_h
    assert torch.equal(state.table.rows, state_h.table.rows)


@pytest.mark.parametrize("policy", CACHE_POLICIES)
def test_policy_counters_equal_jax(policy):
    kw = dict(capacity=32, miss_bucket=8, chunk_rows=4, policy=policy)
    init, jstats, jtable = _jax_run("cached", **kw)
    state, stats = _port_run_from(init, "cached", **kw)
    np.testing.assert_allclose(stats.losses, jstats.losses, rtol=0, atol=1e-5)
    assert _max_diff(state.table.rows, jtable.rows) <= 1e-5
    for k in COUNTERS:
        assert stats.store_metrics[k] == jstats.store_metrics[k], k
    assert stats.store_metrics["cache_evictions"] > 0
    assert stats.store_metrics["cache_policy_chunks"] == \
        jstats.store_metrics["cache_policy_chunks"]


# ---------------------------------------------------------------------------
# burst accounting
# ---------------------------------------------------------------------------


def test_chunk_bursts_never_exceed_the_misses():
    """``h2d_bursts`` counts staged chunks: one per miss at
    ``chunk_rows=1``, and at a coarser chunk each burst carries at least
    one miss. (Whether chunks coalesce more than a row-granular cache of
    the same size evicts depends on the workload: on this one, 8 chunk
    slots under lru stage 377 bursts against 323 rows.)"""
    _, _, store_1 = run_port("cached", capacity=32, miss_bucket=8, chunk_rows=1)
    assert store_1.h2d_bursts == store_1.misses  # every miss its own burst
    _, _, store_k = run_port("cached", capacity=32, miss_bucket=8, chunk_rows=4,
                             policy="lru")
    assert store_k.h2d_bursts < store_k.misses
    assert store_k.d2h_bursts >= store_k.evictions  # flush writes back too
    m = store_k.metrics()
    for k in ("h2d_bursts", "d2h_bursts", "cache_chunk_rows", "cache_policy_chunks"):
        assert k in m
