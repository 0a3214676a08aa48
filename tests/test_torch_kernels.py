"""The port's kernels' plain versions against the JAX package's dispatch.

- the plain PyTorch gather (what a CPU tensor runs) equals JAX
  ``dispatch.gather_rows`` under both the reference and the interpret
  backends, bit for bit, on the sweep of tests/test_dispatch.py with 30%
  sentinel slots;
- the plain segment sum equals JAX ``dispatch.segment_rowsum`` under both
  backends on the sweep of tests/test_dispatch.py (sorted ids) extended
  with unsorted ids, drop ids at ``S`` and ``SENTINEL`` and D in
  {1, 33, 128}: bit for bit on integer-valued grads, and within
  ``rtol=1e-6, atol=1e-6`` on normal grads (XLA's scatter-add and the
  interpreter's one-hot matmul may add in another order);
- the plain buffer sync equals JAX ``dispatch.buffer_sync`` under both
  backends bit for bit, misses at ``Ka`` and ``SENTINEL`` and negative
  sources included (both JAX backends wrap -1 to the last active row), and
  its fused accumulator select equals the JAX engine's ``jnp.where``;
- negative indices are compared port against port only: JAX's reference
  backend (``jnp.take(mode="fill")``) wraps -1 to the last row while the
  Pallas path zeroes it. The engine never makes negative indices; the trap
  is pinned below, not fixed;
- the CUDA kernel wrapper launches nothing on CPU tensors; it is held
  against the plain version on the card by tests/test_torch_cuda.py.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.kernels import dispatch as jdispatch
from repro_torch.core.embedding.routing import SENTINEL
from repro_torch.kernels import build, dispatch, ref
from repro_torch.kernels import buffer_sync as bs
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import embedding_scatter as es
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import segment_rowsum as sr


def _case(rows, d, n, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, d)).astype(np.float32)
    idx = rng.integers(0, rows, size=n)
    miss = rng.random(n) < 0.3  # sentinel-miss slots -> zero rows
    idx[miss] = np.where(rng.random(n) < 0.5, rows, SENTINEL)[miss]
    return table, idx.astype(np.int32)


@pytest.mark.parametrize("backend", ["reference", "interpret"])
@pytest.mark.parametrize("rows,d,n", [(64, 128, 37), (100, 96, 200), (32, 33, 8)])
def test_plain_gather_bitwise_equals_jax(rows, d, n, backend):
    table, idx = _case(rows, d, n)
    want = np.asarray(jdispatch.gather_rows(
        jnp.asarray(table), jnp.asarray(idx), backend=backend))
    got = dispatch.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[idx >= rows], 0.0)


def test_cpu_path_never_counts_a_launch():
    kernels = (eg, sr, bs, es)
    before = [k.launches for k in kernels]
    table, idx = _case(50, 33, 64, seed=1)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    for _ in range(3):
        dispatch.gather_rows(t, i)
        i = i[:50]
        dispatch.segment_rowsum(t, i, 50)
        dispatch.buffer_sync(t, t[:, 0].contiguous(), t, t[:, 1].contiguous(), i)
        dispatch.scatter_rows(t.clone(), t[:, 0].clone(), i, t, t[:, 1].contiguous())
    assert [k.launches for k in kernels] == before


def test_negative_indices_give_zero_rows_port_against_port():
    table, idx = _case(40, 33, 50, seed=2)
    idx[::4] = -1
    idx[1::7] = -(2 ** 31)
    got = ref.gather_rows_ref(torch.from_numpy(table), torch.from_numpy(idx))
    valid = (idx >= 0) & (idx < 40)
    want = np.where(valid[:, None], table[np.clip(idx, 0, 39)], 0.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_jax_backends_disagree_on_negative_indices():
    """The trap the port must not compare across: reference wraps, the
    Pallas path (interpret) zeroes."""
    table = jnp.asarray(np.arange(12, dtype=np.float32).reshape(4, 3))
    idx = jnp.asarray([-1, 1], jnp.int32)
    wrapped = np.asarray(jdispatch.gather_rows(table, idx, backend="reference"))
    zeroed = np.asarray(jdispatch.gather_rows(table, idx, backend="interpret"))
    np.testing.assert_array_equal(wrapped[0], np.asarray(table)[-1])
    np.testing.assert_array_equal(zeroed[0], 0.0)
    port = ref.gather_rows_ref(torch.from_numpy(np.array(table)),
                               torch.tensor([-1, 1], dtype=torch.int32))
    np.testing.assert_array_equal(port.numpy(), zeroed)


def test_empty_gather_has_row_width():
    out = dispatch.gather_rows(torch.zeros((5, 33)),
                               torch.zeros((0,), dtype=torch.int32))
    assert out.shape == (0, 33)


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        eg.embedding_gather(torch.zeros((4, 8)), torch.zeros((2,), dtype=torch.int32))


def test_library_path_tracks_source_and_lives_in_build():
    p = build.library_path("embedding_gather")
    assert p.parent == build.BUILD_DIR
    assert p.parent.parent == build.CSRC.parents[2]  # the repo root
    assert p == build.library_path("embedding_gather")


def _segment_case(l, s, d, *, sort, integer, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s + 1, size=l)  # id == s drops
    ids[rng.random(l) < 0.1] = SENTINEL
    if sort:
        ids = np.sort(ids)
    grads = (rng.integers(-8, 8, size=(l, d)) if integer
             else rng.normal(size=(l, d))).astype(np.float32)
    return grads, ids.astype(np.int32)


@pytest.mark.parametrize("backend", ["reference", "interpret"])
@pytest.mark.parametrize("l,s,d", [(64, 16, 64), (200, 50, 96), (96, 256, 128),
                                   (150, 40, 1), (77, 9, 33), (300, 128, 128)])
@pytest.mark.parametrize("sort", [True, False])
def test_plain_segment_rowsum_equals_jax(l, s, d, sort, backend):
    for integer in (True, False):
        grads, ids = _segment_case(l, s, d, sort=sort, integer=integer)
        want = np.asarray(jdispatch.segment_rowsum(
            jnp.asarray(grads), jnp.asarray(ids), s, backend=backend))
        got = dispatch.segment_rowsum(torch.from_numpy(grads),
                                      torch.from_numpy(ids), s)
        assert got.dtype == torch.float32 and got.shape == (s, d)
        if integer:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_plain_segment_rowsum_drops_negative_ids_port_against_port():
    """JAX's reference backend wraps -1 to the last segment and its Pallas
    path drops it; the port drops it (compared port against port)."""
    grads = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([-1, 2, 0, 2], np.int32)
    got = ref.segment_rowsum_ref(torch.from_numpy(grads), torch.from_numpy(ids), 3)
    np.testing.assert_array_equal(
        got.numpy(), [grads[2], np.zeros(3), grads[1] + grads[3]])
    wrapped = np.asarray(jdispatch.segment_rowsum(
        jnp.asarray(grads), jnp.asarray(ids), 3, backend="reference"))
    dropped = np.asarray(jdispatch.segment_rowsum(
        jnp.asarray(grads), jnp.asarray(ids), 3, backend="interpret"))
    np.testing.assert_array_equal(wrapped[2], grads[0] + grads[1] + grads[3])
    np.testing.assert_array_equal(dropped, got.numpy())


def test_empty_segment_rowsum_is_zeros():
    out = dispatch.segment_rowsum(torch.zeros((0, 5)),
                                  torch.zeros((0,), dtype=torch.int32), 4)
    assert out.shape == (4, 5) and not out.any()


@pytest.mark.parametrize("backend", ["reference", "interpret"])
@pytest.mark.parametrize("ka,kp,d", [(32, 16, 64), (128, 128, 100), (8, 64, 40),
                                     (20, 30, 1), (50, 40, 33), (64, 64, 128)])
def test_plain_buffer_sync_equals_jax(ka, kp, d, backend):
    rng = np.random.default_rng(2)
    act = rng.normal(size=(ka, d)).astype(np.float32)
    pre = rng.normal(size=(kp, d)).astype(np.float32)
    aa, pa = rng.random(ka).astype(np.float32), rng.random(kp).astype(np.float32)
    src = rng.integers(0, ka, size=kp)
    src[rng.random(kp) < 0.4] = ka  # misses keep the prefetch row
    src[rng.random(kp) < 0.1] = SENTINEL
    src[::9] = -1  # both JAX backends wrap -1 to the last active row
    src = src.astype(np.int32)
    want = np.asarray(jdispatch.buffer_sync(
        jnp.asarray(act), jnp.asarray(pre), jnp.asarray(src), backend=backend))
    # the accumulator select of EmbeddingEngine.sync_buffers
    want_acc = np.asarray(jnp.where(jnp.asarray(src) < ka,
                                    jnp.asarray(aa)[jnp.minimum(src, ka - 1)],
                                    jnp.asarray(pa)))
    rows, accum = dispatch.buffer_sync(*(torch.from_numpy(x)
                                         for x in (act, aa, pre, pa, src)))
    np.testing.assert_array_equal(rows.numpy(), want)
    np.testing.assert_array_equal(accum.numpy(), want_acc)
    np.testing.assert_array_equal(rows.numpy()[src == -1], np.broadcast_to(
        act[-1], ((src == -1).sum(), d)))


def test_plain_scatter_drops_sentinels_and_writes_in_place():
    table = torch.zeros((6, 3))
    accum = torch.zeros(6)
    idx = torch.tensor([4, 6, 1, SENTINEL, -1], dtype=torch.int32)
    rows = torch.arange(15, dtype=torch.float32).reshape(5, 3) + 1
    dispatch.scatter_rows(table, accum, idx, rows, torch.arange(5.0) + 1)
    want = torch.zeros((6, 3))
    want[4], want[1] = rows[0], rows[2]
    assert torch.equal(table, want)
    assert accum.tolist() == [0, 3, 0, 0, 1, 0]


@pytest.mark.parametrize("fn,args", [
    (sr.segment_rowsum, (torch.zeros((2, 4)), torch.zeros(2, dtype=torch.int32), 3)),
    (bs.buffer_sync, (torch.zeros((2, 4)), torch.zeros(2), torch.zeros((2, 4)),
                      torch.zeros(2), torch.zeros(2, dtype=torch.int32))),
    (es.embedding_scatter, (torch.zeros((2, 4)), torch.zeros(2),
                            torch.zeros(2, dtype=torch.int32), torch.zeros((2, 4)),
                            torch.zeros(2))),
    (fa.flash_attention, (torch.zeros((1, 3, 2, 8)), torch.zeros((1, 3, 1, 8)),
                          torch.zeros((1, 3, 1, 8)))),
])
def test_new_kernel_wrappers_reject_cpu_tensors(fn, args):
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)


def test_every_kernel_source_builds_into_build():
    assert set(build.SOURCES) == {"embedding_gather", "segment_rowsum",
                                  "buffer_sync", "embedding_scatter",
                                  "hstu_attention", "flash_attention"}
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
        assert build.library_path(name).parent == build.BUILD_DIR
