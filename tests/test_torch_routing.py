"""Port routing primitives == JAX routing primitives, bit for bit.

Random key windows with sentinel padding and forced overflow (the cases of
tests/test_routing.py and tests/test_fused_routing.py) go through both
packages as numpy; every output leaf must match exactly, dtype included.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.core.embedding import routing as _jr
from repro_torch.core.embedding import routing as tr


class jr:
    """The JAX primitives under ``jax.jit`` (one compile per call instead
    of one per primitive: the same values, a fraction of the test time)."""

    SENTINEL = _jr.SENTINEL
    fixed_unique_window = jax.jit(_jr.fixed_unique_window, static_argnums=1)
    fixed_unique = jax.jit(_jr.fixed_unique, static_argnums=1)
    bucket_by_owner_window = jax.jit(_jr.bucket_by_owner_window,
                                     static_argnums=(1, 2, 3))
    bucket_by_owner = jax.jit(_jr.bucket_by_owner, static_argnums=(1, 2, 3))
    sorted_lookup = jax.jit(_jr.sorted_lookup)
    intersect_sorted = jax.jit(_jr.intersect_sorted)
    merge_sorted_unique = jax.jit(_jr.merge_sorted_unique, static_argnums=1)
    owner_of = staticmethod(_jr.owner_of)


def _keys(shape, vocab, seed, pad_frac=0.2):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, vocab, size=shape).astype(np.int32)
    k[rng.random(shape) < pad_frac] = jr.SENTINEL
    return k


def _eq(torch_leaf, jax_leaf):
    j = np.asarray(jax_leaf)
    t = torch_leaf.numpy()
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    np.testing.assert_array_equal(t, j)


def test_sentinel_matches():
    assert tr.SENTINEL == int(jr.SENTINEL)


@pytest.mark.parametrize("n,l,vocab,u_max", [
    (1, 64, 40, 64),   # roomy
    (2, 50, 500, 24),  # forced overflow
    (4, 33, 30, 8),    # heavy duplication + overflow
    (3, 16, 10_000, 8),
])
def test_fixed_unique_window_bitwise(n, l, vocab, u_max):
    k = _keys((n, l), vocab, seed=n * 7 + l)
    want = jr.fixed_unique_window(jnp.asarray(k), u_max)
    got = tr.fixed_unique_window(torch.from_numpy(k), u_max)
    for g, w in zip(got, want):
        _eq(g, w)
    if u_max < l:  # the forced-overflow cases really overflow
        assert int(got.overflow.max()) > 0


def test_fixed_unique_single_row_bitwise():
    k = _keys((77,), 50, seed=3)
    for g, w in zip(tr.fixed_unique(torch.from_numpy(k), 32),
                    jr.fixed_unique(jnp.asarray(k), 32)):
        _eq(g, w)


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("n,nk,cap", [(1, 40, 48), (2, 64, 8), (4, 30, 5)])
def test_bucket_by_owner_window_bitwise(shards, n, nk, cap):
    vocab = 1024
    rps = vocab // shards
    k = _keys((n, nk), vocab, seed=shards * 11 + nk)
    uniq = jr.fixed_unique_window(jnp.asarray(k), nk).unique_keys
    want = jr.bucket_by_owner_window(uniq, shards, cap, rps)
    got = tr.bucket_by_owner_window(torch.from_numpy(np.asarray(uniq)), shards,
                                    cap, rps)
    for g, w in zip(got, want):
        _eq(g, w)
    single_w = jr.bucket_by_owner(uniq[0], shards, cap, rps)
    single_g = tr.bucket_by_owner(torch.from_numpy(np.asarray(uniq[0])),
                                  shards, cap, rps)
    for g, w in zip(single_g, single_w):
        _eq(g, w)


def test_forced_bucket_overflow_is_counted():
    k = np.arange(32, dtype=np.int32)[None]  # 32 uniques, all on shard 0
    got = tr.bucket_by_owner_window(torch.from_numpy(k), 1, 8, 1024)
    want = jr.bucket_by_owner_window(jnp.asarray(k), 1, 8, 1024)
    assert int(got.overflow[0]) == 24
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("nk,nq", [(64, 100), (8, 33), (128, 1)])
def test_sorted_lookup_bitwise(nk, nq):
    rng = np.random.default_rng(nk + nq)
    keys = np.asarray(jr.merge_sorted_unique(
        jnp.asarray(_keys((nk,), 200, seed=nk)), nk))
    q = np.concatenate([keys[rng.integers(0, nk, size=nq // 2)],
                        rng.integers(0, 200, size=nq - nq // 2).astype(np.int32)])
    q[::5] = jr.SENTINEL
    _eq(tr.sorted_lookup(torch.from_numpy(keys), torch.from_numpy(q)),
        jr.sorted_lookup(jnp.asarray(keys), jnp.asarray(q)))
    _eq(tr.intersect_sorted(torch.from_numpy(keys), torch.from_numpy(q)),
        jr.intersect_sorted(jnp.asarray(keys), jnp.asarray(q)))


@pytest.mark.parametrize("shape,out_cap", [((3, 40), 128), ((2, 4, 9), 16)])
def test_merge_sorted_unique_bitwise(shape, out_cap):
    k = _keys(shape, 300, seed=sum(shape))
    _eq(tr.merge_sorted_unique(torch.from_numpy(k), out_cap),
        jr.merge_sorted_unique(jnp.asarray(k), out_cap))


def test_owner_of_numpy_and_torch():
    k = _keys((200,), 1000, seed=5)
    want = np.asarray(jr.owner_of(jnp.asarray(k), 256, 4))
    np.testing.assert_array_equal(tr.owner_of(k, 256, 4), want)
    np.testing.assert_array_equal(tr.owner_of(torch.from_numpy(k), 256, 4).numpy(),
                                  want)
