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
- the choice between the three ``flash_attention`` kernels is a function
  of type and head dim alone, never of strides or alignment, checked on
  CPU tensors;
- a CPU model of the ``tf32x3`` flash forward's arithmetic
  (``ref.flash_attention_fwd_tf32``: both products in split-precision
  TF32, either tie rule) holds ``ref.flash_attention_bound`` against the
  plain version and JAX's oracle, and its lse
  ``ref.flash_attention_lse_bound``, at hd 64 with H/KV 1 and 4 and on
  the port's ``fuxi-reduced`` layer 0 inputs, causal and full; one TF32
  pass misses the bound. The model truncates at each MMA as the tensor
  cores do: on values of one sign the kernel's short MMA chains hold the
  bound and the first form's long ones miss it;
- the plain buffer sync equals JAX ``dispatch.buffer_sync`` under both
  backends bit for bit, misses at ``Ka`` and ``SENTINEL`` and negative
  sources included (both JAX backends wrap -1 to the last active row), and
  its fused accumulator select equals the JAX engine's ``jnp.where``;
- negative indices are compared port against port only: JAX's reference
  backend (``jnp.take(mode="fill")``) wraps -1 to the last row while the
  Pallas path zeroes it. The engine never makes negative indices; the trap
  is pinned below, not fixed;
- the CUDA kernel wrapper launches nothing on CPU tensors; it is held
  against the plain version on the card by tests/test_torch_cuda.py;
- the gather kernel's launch plan (``embedding_gather.launch_plan``, a
  pure function of the shape) covers every output element exactly once
  without a vector crossing its row's end or its alignment, keeps its grid
  within ``INT_MAX`` blocks and spreads the LM decode's calls over at least
  32 blocks; a numpy emulation that copies by the plan as the kernel does
  equals the plain version bit for bit, sentinels and negative indices
  included.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_fuxi_inputs import fuxi_layer0_qkv
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


def test_library_path_tracks_the_headers(tmp_path, monkeypatch):
    """An edited header in ``csrc/`` changes every library's path, so the
    next use rebuilds it; the path comes back with the header's bytes. The
    three f32 tensor-core sources include the shared one."""
    for name in ("hstu_attention", "flash_attention_tf32", "flash_attention_bwd_tf32"):
        assert '#include "tf32_mma.cuh"' in (build.CSRC / f"{name}.cu").read_text()
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("a")
    header.write_text("// two\n")
    assert build.library_path("a") != first
    header.write_text("// one\n")
    assert build.library_path("a") == first
    (tmp_path / "other.cuh").write_text("// a second header\n")
    assert build.library_path("a") != first


def _emulate_gather(plan, table, idx, batch=1024):
    """The gather kernel's copy by its launch plan, in numpy: every warp of
    the grid walks its items in a grid-stride loop; lanes below
    ``rows_per_warp`` load the warp's indices; load j of lane l moves unit
    32 j + l of the item's ``rows_per_warp`` x ``span`` units, reading its
    row's index from lane (32 j + l) // span by a shuffle. ``table`` holds
    any element type (its bits are copied). Returns the output and how many
    times each of its elements was written; asserts that no load crosses its
    row's end or breaks its vector's alignment."""
    rows, dim = table.shape
    n, e = idx.shape[0], table.itemsize
    ve = plan.vec_bytes // e  # elements a load moves
    width = dim // ve
    out = np.zeros((n, dim), dtype=table.dtype)
    counts = np.zeros(n * dim, dtype=np.int64)
    warps = plan.blocks * plan.warps_per_block
    iters = -(-plan.items // warps) if plan.items else 0
    visits = (np.arange(warps)[:, None] + warps * np.arange(iters)[None, :]).ravel()
    visits = visits[visits < plan.items]
    lane = np.arange(32)
    rpw, span = plan.rows_per_warp, plan.span
    u = (32 * np.arange(plan.loads)[:, None] + lane[None, :]).ravel()  # (j, lane)
    k, col = u // span, u % span  # the unit's row in the warp, its column
    t = np.arange(ve)
    for b0 in range(0, visits.size, batch):
        item = visits[b0:b0 + batch]
        row0 = item // plan.chunks_per_row * rpw
        chunk = item % plan.chunks_per_row
        slot = row0[:, None] + lane[None, :]
        mine = np.where((lane < rpw)[None, :] & (slot < n),
                        idx[np.minimum(slot, n - 1)], -1)
        r = mine[:, k]  # the shuffle: a unit of row k reads lane k
        i = row0[:, None] + k[None, :]
        v = chunk[:, None] * span + col[None, :]
        live = (i < n) & (v < width)
        i_l = i[live]
        r_l = r[live].astype(np.int64)
        first = v[live] * ve
        assert (first + ve <= dim).all()  # never past the row's end
        valid = (r_l >= 0) & (r_l < rows)
        if plan.vec_bytes == 16:  # both base pointers 16-byte aligned
            assert ((i_l * dim + first) * e % 16 == 0).all()
            assert ((r_l[valid] * dim + first[valid]) * e % 16 == 0).all()
        dst = (i_l * dim + first)[:, None] + t
        src = (np.where(valid, r_l, 0) * dim + first)[:, None] + t
        out.reshape(-1)[dst] = np.where(valid[:, None], table.reshape(-1)[src], 0)
        counts += np.bincount(dst.ravel(), minlength=n * dim)
    return out, counts.reshape(n, dim)


_PLAN_DIMS = [1, 33, 128, 512, 5120, 5121]
_PLAN_NS = [0, 1, 7, 8, 31, 32, 33, 777]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("d", _PLAN_DIMS)
def test_gather_plan_covers_every_element_once(d, elem_bytes, aligned):
    table = np.zeros((3, d), dtype=np.float32 if elem_bytes == 4 else np.uint16)
    for n in _PLAN_NS:
        plan = eg.launch_plan(n, d, elem_bytes, aligned)
        vec = 16 if aligned and d * elem_bytes % 16 == 0 else elem_bytes
        assert plan.vec_bytes == vec and plan.loads * vec == eg.LANE_BYTES
        assert 32 % plan.rows_per_warp == 0
        assert plan.chunks_per_row == 1 or plan.rows_per_warp == 1
        assert 1 <= plan.warps_per_block <= eg.MAX_WARPS_PER_BLOCK
        idx = (np.arange(n) % 3).astype(np.int32)
        _, counts = _emulate_gather(plan, table, idx)
        assert (counts == 1).all(), (n, plan)
        if plan.items > 1:  # a smaller grid: the grid-stride loop covers it
            _, counts = _emulate_gather(plan._replace(blocks=1, warps_per_block=1),
                                        table, idx)
            assert (counts == 1).all(), (n, plan)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", _PLAN_DIMS)
def test_gather_emulation_equals_plain_bit_for_bit(d, dtype, aligned):
    rng = np.random.default_rng(d)
    rows = 50
    t = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).to(dtype)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for n in (1, 33, 777):
        idx = rng.integers(0, rows, size=n).astype(np.int32)
        idx[::5] = rows
        idx[1::7] = SENTINEL
        idx[2::9] = -1
        idx[3::11] = -(2 ** 31)
        want = ref.gather_rows_ref(t, torch.from_numpy(idx)).view(bits).numpy()
        plan = eg.launch_plan(n, d, t.element_size(), aligned)
        got, counts = _emulate_gather(plan, t.view(bits).numpy(), idx)
        np.testing.assert_array_equal(got, want)
        assert (counts == 1).all()


@pytest.mark.parametrize("n,d,elem_bytes", [
    (319_488, 128, 4),  # the dlrm-ctr retrieve
    (65_536, 5_120, 4),  # the stablelm-12b prefill retrieve
    (2 ** 31 - 1, 5_120, 4),  # past the grid: the grid-stride loop
])
def test_gather_plan_blocks_stay_within_int_max(n, d, elem_bytes):
    plan = eg.launch_plan(n, d, elem_bytes, aligned=True)
    assert 1 <= plan.blocks <= 2 ** 31 - 1
    assert plan.items == -(-n // plan.rows_per_warp) * plan.chunks_per_row
    iters = -(-plan.items // (plan.blocks * plan.warps_per_block))
    assert plan.blocks * plan.warps_per_block * iters >= plan.items


@pytest.mark.parametrize("n,d,elem_bytes,chunk_bytes,rows_per_warp,blocks", [
    (32, 5_120, 4, 2048, 1, 160),  # the LM decode retrieve: 10 chunks a row
    (8, 5_120, 2, 2048, 1, 40),  # each LM decode assembly: 5 chunks a row
    (13_312, 128, 4, 512, 4, 416),  # a DLRM serve window's assemblies
    (65_536, 512, 2, 1024, 2, 4_096),  # an HSTU assembly
])
def test_gather_plan_spreads_the_main_path_shapes(n, d, elem_bytes, chunk_bytes,
                                                  rows_per_warp, blocks):
    plan = eg.launch_plan(n, d, elem_bytes, aligned=True)
    assert (plan.chunk_bytes, plan.rows_per_warp, plan.blocks) == (
        chunk_bytes, rows_per_warp, blocks)
    assert plan.blocks >= 32


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
                                  "flash_attention_wgmma", "flash_attention_bwd",
                                  "flash_attention_tf32", "flash_attention_bwd_tf32",
                                  "flash_attention_bwd_wgmma"}
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
     "simple"),                                           # f32 above hd 128
    *[(_view((2, 9, 4, hd), torch.float32), _view((2, 9, 1, hd), torch.float32), want)
      for hd, want in ((8, "tf32x3"), (64, "tf32x3"), (128, "tf32x3"), (160, "simple"),
                       (256, "simple"))],
    (_view((2, 9, 4, 64), torch.float32, 3, 5), _view((2, 9, 1, 64), torch.float32, 1),
     "tf32x3"),                                           # f32 off 16-byte alignment
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


def _flash_tf32_case(name):
    if name == "fuxi-reduced layer 0":
        return fuxi_layer0_qkv()
    kv = {"hd 64, H/KV 1": 4, "hd 64, H/KV 4": 1}[name]
    rng = np.random.default_rng(13)
    return [torch.from_numpy(rng.normal(size=(2, 64, n, 64)).astype(np.float32))
            for n in (4, kv, kv)]


FLASH_TF32_CASES = ["hd 64, H/KV 1", "hd 64, H/KV 4", "fuxi-reduced layer 0"]


@pytest.mark.parametrize("ties", ["even", "away"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", FLASH_TF32_CASES)
def test_tf32x3_flash_forward_holds_the_kernel_limit(case, causal, ties):
    """The ``tf32x3`` flash forward's two products in split precision (as
    the CUDA kernel takes them, split with either tie rule) stay within the
    limits chip_smoke holds the kernel to: the output within
    ``ref.flash_attention_bound`` (1e-5 of sum_j w_ij |v_j| + 1e-7) of the
    plain version and of JAX's ``flash_attention_ref``, the lse within
    ``ref.flash_attention_lse_bound``."""
    q, k, v = _flash_tf32_case(case)
    out, lse = ref.flash_attention_fwd_tf32(q, k, v, causal, passes=3, ties=ties)
    want = ref.flash_attention_ref(q, k, v, causal)
    bound = ref.flash_attention_bound(q, k, v, want, causal)
    assert out.shape == want.shape and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert bool(((out - want).abs() <= bound).all())
    h = q.shape[2]
    oracle = jref.flash_attention_ref(*(jnp.asarray(x.numpy()) for x in (
        q, ref.repeat_kv(k, h), ref.repeat_kv(v, h))), causal=causal)
    assert bool(((out - torch.from_numpy(np.array(oracle))).abs() <= bound).all())
    lse_want = ref.flash_attention_lse_ref(q, k, causal)
    assert bool(((lse - lse_want).abs()
                 <= ref.flash_attention_lse_bound(q, k, lse_want, causal)).all())


def test_mma_model_truncates_toward_zero():
    """``ref._mma`` adds the exact sum of its 8 products to the accumulator
    and truncates once: a product below half an ulp leaves a positive sum
    where it was and takes a negative one an ulp toward zero, where
    rounding to nearest would leave both."""
    one = torch.ones((1, 1))
    a = torch.zeros((1, 8))
    a[0, 0] = 2.0 ** -30
    b = torch.ones((1, 8))
    eq = "qk,dk->qd"
    assert float(ref._mma(one, eq, a, b)) == 1.0
    assert float(ref._mma(-one, eq, a, b)) == -1.0 + 2.0 ** -24
    assert float(ref._mma(one, eq, -a, b)) == 1.0 - 2.0 ** -24
    assert float(ref._mma(one, eq, 4 * a, b * 2.0 ** 8)) == 1.0 + 2.0 ** -20  # exact


def _same_sign_case(seed):
    """Values of one sign at FuXi's hd 64 and 1024 keys: q and k x 2
    (scores of std ~4), v shifted by 2, so every MMA sum of P v runs one
    way."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 1024, 2, 64)).astype(np.float32))
               for _ in range(3))
    return 2 * q, 2 * k, v + 2


@pytest.fixture
def one_thread():
    """One intra-op thread for a test of many small tensor ops: with the
    suite's workers sharing the cores, more threads only contend (this
    file's same-sign case took 200-280 s of what one thread does in a few)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("ties", ["even", "away"])
def test_short_mma_chains_hold_the_limit_where_long_ones_miss_it(ties):
    """The tensor cores add truncating, so a sum that runs through one MMA
    chain drifts toward zero. On values of one sign the kernel's short
    chains (S's small products apart, each step's P v from zero) hold
    ``ref.flash_attention_bound`` and the lse bound; the first form's long
    chains (one chain a sum through every step) miss the bound. The model
    truncates at most one ulp an MMA, less than the tensor cores lose (on
    an H100 the long form read past the bound on such values at 512 keys),
    so the case takes 1024 keys for the drift to show here."""
    q, k, v = _same_sign_case(seed=21)
    want = ref.flash_attention_ref(q, k, v, True)
    bound = ref.flash_attention_bound(q, k, v, want, True)
    out, lse = ref.flash_attention_fwd_tf32(q, k, v, True, ties=ties)
    assert bool(((out - want).abs() <= bound).all())
    lse_want = ref.flash_attention_lse_ref(q, k, True)
    assert bool(((lse - lse_want).abs()
                 <= ref.flash_attention_lse_bound(q, k, lse_want, True)).all())
    long_out, _ = ref.flash_attention_fwd_tf32(q, k, v, True, ties=ties, chains="long")
    assert not bool(((long_out - want).abs() <= bound).all())


@pytest.mark.parametrize("ties", ["even", "away"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", FLASH_TF32_CASES)
def test_one_pass_tf32_flash_forward_misses_the_kernel_limit(case, causal, ties):
    """One TF32 pass misses ``ref.flash_attention_bound``: the reason the
    kernel takes three."""
    q, k, v = _flash_tf32_case(case)
    out, _ = ref.flash_attention_fwd_tf32(q, k, v, causal, passes=1, ties=ties)
    want = ref.flash_attention_ref(q, k, v, causal)
    assert not bool(((out - want).abs()
                     <= ref.flash_attention_bound(q, k, v, want, causal)).all())
