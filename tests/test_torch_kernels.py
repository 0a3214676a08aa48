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
- the chunk-ordered plain segment sum (the CUDA kernel's order: a run cut
  into chunks of ``CHUNK`` positions, chunk sums added in order) equals JAX's
  ``segment_rowsum_ref`` bit for bit on integer-valued grads and within
  the reordering bound on normal grads, hot keys included; it equals the
  input-order plain version bit for bit on runs of at most one chunk, and
  a loop over the chunks at any chunk size;
- the choice between the two ``flash_attention`` kernels is a function of
  type, head dim, strides and alignment, checked on CPU tensors;
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
from repro.kernels import ref as jref
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
                                  "hstu_attention", "flash_attention",
                                  "flash_attention_wgmma"}
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
        assert build.library_path(name).parent == build.BUILD_DIR


def _hot_case(l, s, d, hot, *, integer, seed):
    """``l`` ids over ``s`` segments, ``hot`` of them (and no other) on
    segment 1, drops at ``s``, ``SENTINEL`` and -1; normal or integer-valued
    grads."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s - 1, size=l)
    ids[ids >= 1] += 1
    ids[rng.permutation(l)[:hot]] = 1
    drop = rng.random(l) < 0.1
    ids[drop] = rng.choice([s, SENTINEL, -1], size=int(drop.sum()))
    grads = (rng.integers(-8, 8, size=(l, d)) if integer
             else rng.normal(size=(l, d))).astype(np.float32)
    return grads, ids.astype(np.int32)


@pytest.mark.parametrize("l,s,d,hot", [(600, 40, 64, 0), (900, 30, 33, 300),
                                       (1500, 50, 128, 1100), (5800, 64, 16, 5400),
                                       (300, 7, 1, 257)])
def test_chunked_segment_rowsum_equals_jax(l, s, d, hot):
    """Bit for bit on integer grads (every order gives the exact sum);
    within (n - 1) 2**-24 of each output's sum of magnitudes on normal
    grads, n the longest run (two orders of one f32 sum of n terms)."""
    for integer in (True, False):
        grads, ids = _hot_case(l, s, d, hot, integer=integer, seed=l + hot)
        jids = np.where((ids >= 0) & (ids < s), ids, s)  # JAX's ref drops id == s only
        want = np.asarray(jref.segment_rowsum_ref(jnp.asarray(grads), jnp.asarray(jids), s))
        got = ref.segment_rowsum_chunked_ref(torch.from_numpy(grads), torch.from_numpy(ids), s,
                                             chunk=sr.CHUNK).numpy()
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            keep = jids < s
            mag = np.zeros((s, d), np.float64)
            np.add.at(mag, jids[keep], np.abs(grads[keep]).astype(np.float64))
            n = np.bincount(jids[keep], minlength=s).max()
            assert (np.abs(got - want) <= (n - 1) * 2.0 ** -24 * mag + 1e-30).all()


@pytest.mark.parametrize("l,s,d,hot", [(400, 20, 64, sr.CHUNK), (700, 90, 33, sr.CHUNK - 1),
                                       (256, 8, 128, 0), (3000, 200, 8, 40)])
def test_chunked_segment_rowsum_is_input_order_on_short_runs(l, s, d, hot):
    grads, ids = _hot_case(l, s, d, hot, integer=False, seed=l)
    g, i = torch.from_numpy(grads), torch.from_numpy(ids)
    kept = ids[(ids >= 0) & (ids < s)]
    assert np.bincount(kept, minlength=s).max() <= sr.CHUNK
    assert torch.equal(ref.segment_rowsum_chunked_ref(g, i, s, chunk=sr.CHUNK),
                       ref.segment_rowsum_ref(g, i, s))


@pytest.mark.parametrize("chunk", [1, 3, 7, 64])
def test_chunked_segment_rowsum_sums_chunk_by_chunk(chunk):
    """The plain version against a loop: each segment's rows in input order,
    cut every ``chunk`` rows, each chunk summed from zero, the chunk sums
    added in order."""
    grads, ids = _hot_case(200, 6, 5, 120, integer=False, seed=chunk)
    want = np.zeros((6, 5), np.float32)
    for seg in range(6):
        rows = grads[ids == seg]
        total = np.zeros(5, np.float32)
        for c0 in range(0, len(rows), chunk):
            part = np.zeros(5, np.float32)
            for r in rows[c0:c0 + chunk]:
                part = part + r
            total = part if c0 == 0 else total + part
        want[seg] = total
    got = ref.segment_rowsum_chunked_ref(torch.from_numpy(grads), torch.from_numpy(ids), 6,
                                         chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)


def _view(shape, dtype, offset=0, pad=0):
    """A (B, T, heads, hd) view ``offset`` elements into rows padded by
    ``pad`` elements past hd, like a column slice of a fused projection."""
    b, t, h, hd = shape
    wide = torch.zeros((b, t, h, hd + offset + pad), dtype=dtype)
    return wide[..., offset:offset + hd]


@pytest.mark.parametrize("q,k,want", [
    (_view((8, 64, 32, 160), torch.bfloat16), _view((8, 64, 8, 160), torch.bfloat16),
     "wgmma"),                                            # the main path's shape
    *[(_view((2, 9, 4, hd), torch.bfloat16), _view((2, 9, 1, hd), torch.bfloat16), "wgmma")
      for hd in (64, 80, 128, 192, 256)],
    (_view((2, 9, 4, 160), torch.bfloat16, 8, 320), _view((2, 9, 1, 160), torch.bfloat16, 8, 8),
     "wgmma"),                                            # aligned column slices
    (_view((8, 64, 32, 160), torch.float32), _view((8, 64, 8, 160), torch.float32),
     "simple"),                                           # f32
    (_view((2, 9, 4, 8), torch.bfloat16), _view((2, 9, 1, 8), torch.bfloat16), "simple"),
    (_view((2, 9, 4, 96), torch.bfloat16), _view((2, 9, 1, 96), torch.bfloat16), "simple"),
    # views TMA cannot describe: the layout does not pick the kernel (they
    # are copied for it), so the same values give the same bits
    (_view((2, 9, 4, 160), torch.bfloat16, 3, 5), _view((2, 9, 1, 160), torch.bfloat16),
     "wgmma"),                                            # off 16-byte alignment
    (_view((2, 9, 4, 160), torch.bfloat16, 0, 4), _view((2, 9, 1, 160), torch.bfloat16),
     "wgmma"),                                            # a stride of 164: not 16 bytes
    (_view((2, 9, 4, 160), torch.bfloat16).transpose(1, 2).contiguous().transpose(1, 2),
     _view((2, 9, 1, 160), torch.bfloat16), "wgmma"),     # heads outside positions
])
def test_flash_kernel_choice(q, k, want):
    assert fa.variant(q, k, k) == want


@pytest.mark.parametrize("x,tma", [
    (_view((8, 64, 32, 160), torch.bfloat16), True),
    (_view((2, 9, 4, 160), torch.bfloat16, 8, 320), True),   # aligned column slice
    (_view((2, 9, 4, 160), torch.bfloat16, 3, 5), False),    # off 16-byte alignment
    (_view((2, 9, 4, 160), torch.bfloat16, 0, 4), False),    # a stride of 164
    (_view((2, 9, 4, 160), torch.bfloat16).transpose(1, 2).contiguous().transpose(1, 2),
     False),                                                 # heads outside positions
])
def test_flash_views_tma_reads_in_place(x, tma):
    """Which views the wgmma kernel reads in place; ``flash_attention``
    copies the others into a contiguous tensor before it launches."""
    assert fa.tma_ok(x) == tma
    assert fa.tma_ok(x.clone(memory_format=torch.contiguous_format))


@pytest.mark.parametrize("ties", ["even", "away"])
def test_tf32_round_is_round_to_nearest(ties):
    """``ref.tf32_round`` keeps 10 mantissa bits, rounding to nearest with
    ties to even (``cvt.rn.tf32.f32``) or away from zero (``cvt.rna``)."""
    ulp = 2.0 ** -10  # of TF32 at 1.0
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23, -(1.0 + ulp / 2),
                      1.0 + 1.5 * ulp, 1.0 + ulp / 2 + 2.0 ** -23, float("inf"),
                      -float("inf")])
    tie_up = ties == "away"  # 1 + ulp / 2 sits between 1 (even) and 1 + ulp (odd)
    want = torch.tensor([1.0, 1.0 + ulp * tie_up, 1.0, -(1.0 + ulp * tie_up),
                         1.0 + 2 * ulp, 1.0 + ulp, float("inf"), -float("inf")])
    got = ref.tf32_round(x, ties)
    assert torch.equal(got, want)
    assert torch.isnan(ref.tf32_round(torch.tensor([float("nan")]), ties)).all()
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    got = ref.tf32_round(r, ties)
    assert bool((got.view(torch.int32) & 0x1FFF == 0).all())
    assert float(((got - r).abs() / r.abs()).max()) <= 2.0 ** -11


def _hstu_bwd_case(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(2, 64, 2, 32)).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("ties", ["even", "away"])
@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_backward_holds_the_kernel_limit(causal, ties):
    """The backward's products in split precision (3xTF32, as the CUDA
    kernels take them, split with either tie rule) stay within the limit
    chip_smoke holds the kernels to: 1e-5 of each output's sum of
    magnitudes plus 1e-7."""
    q, k, v, do = _hstu_bwd_case(seed=7)
    got = ref.hstu_attention_bwd_tf32(q, k, v, do, causal, passes=3, ties=ties)
    want = ref.hstu_attention_bwd_ref(q, k, v, do, causal)
    _, mags = ref.hstu_attention_magnitudes(q, k, v, do, causal)
    for g_, w_, m_ in zip(got, want, mags):
        assert bool(((g_ - w_).abs() <= 1e-5 * m_ + 1e-7).all())


@pytest.mark.parametrize("ties", ["even", "away"])
@pytest.mark.parametrize("causal", [True, False])
def test_one_pass_tf32_backward_misses_the_kernel_limit(causal, ties):
    """One TF32 pass (10 mantissa bits, about 5e-4 relative) cannot meet the
    limit: the reason the kernels take three."""
    q, k, v, do = _hstu_bwd_case(seed=7)
    got = ref.hstu_attention_bwd_tf32(q, k, v, do, causal, passes=1, ties=ties)
    want = ref.hstu_attention_bwd_ref(q, k, v, do, causal)
    _, mags = ref.hstu_attention_magnitudes(q, k, v, do, causal)
    for g_, w_, m_ in zip(got, want, mags):
        assert not bool(((g_ - w_).abs() <= 1e-5 * m_ + 1e-7).all())


def _hstu_fwd_case(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(2, 64, 2, 32)).astype(np.float32))
            for _ in range(3)]


@pytest.mark.parametrize("ties", ["even", "away"])
@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_forward_holds_the_kernel_limit(causal, ties):
    """The forward's two products in split precision (3xTF32, as the CUDA
    kernel takes them, split with either tie rule) stay within the limit
    chip_smoke holds the kernel to: 1e-5 of each output's sum of
    magnitudes plus 1e-7, against the plain version (held against JAX's
    ``hstu_attention`` in tests/test_torch_hstu.py)."""
    q, k, v = _hstu_fwd_case(seed=11)
    got = ref.hstu_attention_fwd_tf32(q, k, v, causal, passes=3, ties=ties)
    want = ref.hstu_attention_ref(q, k, v, causal)
    mag, _ = ref.hstu_attention_magnitudes(q, k, v, torch.zeros_like(v), causal)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= 1e-5 * mag + 1e-7).all())


@pytest.mark.parametrize("ties", ["even", "away"])
@pytest.mark.parametrize("causal", [True, False])
def test_one_pass_tf32_forward_misses_the_kernel_limit(causal, ties):
    """One TF32 pass cannot meet the forward's limit either: the reason the
    kernel takes three."""
    q, k, v = _hstu_fwd_case(seed=11)
    got = ref.hstu_attention_fwd_tf32(q, k, v, causal, passes=1, ties=ties)
    want = ref.hstu_attention_ref(q, k, v, causal)
    mag, _ = ref.hstu_attention_magnitudes(q, k, v, torch.zeros_like(v), causal)
    assert not bool(((got - want).abs() <= 1e-5 * mag + 1e-7).all())
