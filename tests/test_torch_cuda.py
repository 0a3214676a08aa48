"""The port on the card: the hand-written CUDA kernels, the serving path and
the training path.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one (the kernels have no CPU mode). The file imports no jax, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.api import Session
from repro_torch.core.embedding.routing import SENTINEL
from repro_torch.kernels import buffer_sync as bs
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import embedding_scatter as es
from repro_torch.kernels import segment_rowsum as sr
from repro_torch.train import clone_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _case(rows, d, n, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, d)).astype(np.float32)
    idx = rng.integers(0, rows, size=n)
    miss = rng.random(n) < 0.3
    idx[miss] = np.where(rng.random(n) < 0.5, rows, SENTINEL)[miss]
    idx[2::5] = -1
    return table, idx.astype(np.int32)


@pytest.mark.parametrize("rows,d,n", [(64, 128, 37), (100, 96, 200), (32, 33, 8),
                                      (1000, 1, 513), (7, 128, 1), (5, 16, 0)])
def test_kernel_bitwise_equals_plain(cuda_device, rows, d, n):
    table, idx = _case(rows, d, n, seed=rows + n)
    t = torch.from_numpy(table).to(cuda_device)
    i = torch.from_numpy(idx).to(cuda_device)
    before = eg.launches
    got = dispatch.gather_rows(t, i)
    torch.cuda.synchronize()
    assert eg.launches == before + (n > 0)
    assert torch.equal(got, ref.gather_rows_ref(t, i))
    # a contiguous view 4 bytes off 16-byte alignment takes the scalar path
    flat = torch.cat([t.new_zeros(1), t.reshape(-1)])
    shifted = flat[1:].view(rows, d)
    assert torch.equal(eg.embedding_gather(shifted, i), ref.gather_rows_ref(shifted, i))


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    t = torch.zeros((8, 4), device=cuda_device)
    i = torch.zeros((3,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        eg.embedding_gather(t.double(), i)
    with pytest.raises(TypeError):
        eg.embedding_gather(t, i.long())
    with pytest.raises(ValueError):
        eg.embedding_gather(t.t(), i)
    with pytest.raises(ValueError):
        eg.embedding_gather(t, i.cpu())


def test_serving_on_the_card_runs_the_kernel_and_matches_cpu(cuda_device):
    gpu = Session.from_arch("dlrm-ctr", reduced=True, seed=2)
    cpu = Session.from_arch("dlrm-ctr", reduced=True, device="cpu", seed=2)
    model, table = gpu.weights()
    cpu.ingest({k: v.cpu() for k, v in model.state_dict().items()},
               type(table)(table.rows.cpu(), table.accum.cpu()))
    before = eg.launches
    rep = gpu.serve_embeddings(num_requests=40, max_batch=8, head="embedding",
                               check_exact=True)
    windows, chunks = int(rep.summary["windows"]), 5
    assert rep.summary["exact"] == 1
    assert eg.launches - before == 4 * windows + 3 * chunks
    want = cpu.serve_embeddings(num_requests=40, max_batch=8, head="embedding")
    np.testing.assert_array_equal(rep.results, want.results)
    logits = gpu.serve_embeddings(num_requests=40, max_batch=8, head="dlrm",
                                  check_exact=True)
    assert logits.summary["exact"] == 1
    # cuBLAS and the CPU sum f32 products in another order
    np.testing.assert_allclose(
        logits.results,
        cpu.serve_embeddings(num_requests=40, max_batch=8, head="dlrm").results,
        rtol=1e-5, atol=1e-6)


def _misaligned(t):
    """A contiguous copy of ``t`` 4 bytes off 16-byte alignment."""
    flat = torch.cat([t.new_zeros(1), t.reshape(-1)])
    return flat[1:].view(t.shape)


def _segment_case(n, d, s, seed, integer):
    rng = np.random.default_rng(seed)
    grads = rng.normal(size=(n, d)).astype(np.float32)
    if integer:
        grads = np.round(grads * 8).astype(np.float32)
    ids = rng.integers(0, max(s, 1), size=n)  # unsorted, repeats
    drop = rng.random(n) < 0.2
    ids[drop] = rng.choice([s, SENTINEL, -1], size=int(drop.sum()))
    return grads, ids.astype(np.int32)


@pytest.mark.parametrize("n,d,s", [(0, 16, 5), (40, 1, 1), (300, 33, 17),
                                   (1000, 128, 64), (257, 128, 1000)])
def test_segment_rowsum_kernel_equals_plain(cuda_device, n, d, s):
    for integer in (True, False):
        grads, ids = _segment_case(n, d, s, seed=n + d + s, integer=integer)
        g = torch.from_numpy(grads).to(cuda_device)
        i = torch.from_numpy(ids).to(cuda_device)
        before = sr.launches
        got = dispatch.segment_rowsum(g, i, s)
        again = sr.segment_rowsum(g, i, s)
        shifted = sr.segment_rowsum(_misaligned(g), i, s)
        torch.cuda.synchronize()
        assert sr.launches == before + 3 * (n > 0)
        assert got.shape == (s, d) and got.dtype == torch.float32
        assert torch.equal(got, again) and torch.equal(got, shifted)  # deterministic
        # the CPU plain version adds in input order, as the kernel does
        assert torch.equal(got.cpu(), ref.segment_rowsum_ref(
            torch.from_numpy(grads), torch.from_numpy(ids), s))
        want = ref.segment_rowsum_ref(g, i, s)  # atomics on the card
        if integer:
            assert torch.equal(got, want)
        else:
            # the atomics add in another order: reordering an f32 sum of n
            # terms moves it by about sqrt(n) * 6e-8 of its sum of magnitudes
            mag = ref.segment_rowsum_ref(g.abs(), i, s)
            assert bool(((got - want).abs() <= 1e-6 * mag + 1e-6).all())


def _sync_case(ka, kp, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(ka, d)).astype(np.float32)
    p = rng.normal(size=(kp, d)).astype(np.float32)
    aa, pa = rng.random(ka).astype(np.float32), rng.random(kp).astype(np.float32)
    src = rng.integers(0, ka, size=kp)
    src[::3] = ka
    src[1::7] = SENTINEL
    src[2::11] = -1
    return [torch.from_numpy(x) for x in (a, aa, p, pa, src.astype(np.int32))]


@pytest.mark.parametrize("ka,kp,d", [(8, 8, 1), (40, 64, 33), (500, 300, 128),
                                     (1, 5, 16), (9, 0, 4)])
def test_buffer_sync_kernel_equals_plain(cuda_device, ka, kp, d):
    args = [t.to(cuda_device) for t in _sync_case(ka, kp, d, seed=ka + kp)]
    before = bs.launches
    rows, accum = dispatch.buffer_sync(*args)
    a, aa, p, pa, src = args
    rows2, accum2 = bs.buffer_sync(_misaligned(a), aa, _misaligned(p), pa, src)
    torch.cuda.synchronize()
    assert bs.launches == before + 2 * (kp > 0)
    want_rows, want_accum = ref.buffer_sync_ref(*args)
    for got in ((rows, accum), (rows2, accum2)):
        assert torch.equal(got[0], want_rows) and torch.equal(got[1], want_accum)


@pytest.mark.parametrize("r,n,d", [(100, 37, 128), (50, 50, 33), (7, 0, 4), (1000, 300, 1)])
def test_embedding_scatter_kernel_equals_plain(cuda_device, r, n, d):
    rng = np.random.default_rng(r + n)
    table = torch.from_numpy(rng.normal(size=(r, d)).astype(np.float32)).to(cuda_device)
    accum = torch.from_numpy(rng.random(r).astype(np.float32)).to(cuda_device)
    idx = rng.permutation(r)[:n].astype(np.int64)
    idx[::4] = r
    idx[1::9] = SENTINEL
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda_device)
    rows = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda_device)
    racc = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda_device)
    got, got_acc = table.clone(), accum.clone()
    want, want_acc = table.clone(), accum.clone()
    before = es.launches
    dispatch.scatter_rows(got, got_acc, idx, rows, racc)
    ref.embedding_scatter_ref(want, want_acc, idx, rows, racc)
    torch.cuda.synchronize()
    assert es.launches == before + (n > 0)
    assert torch.equal(got, want) and torch.equal(got_acc, want_acc)


def test_new_kernels_reject_what_they_do_not_take(cuda_device):
    g = torch.zeros((6, 4), device=cuda_device)
    i = torch.zeros((6,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        sr.segment_rowsum(g.double(), i, 3)
    with pytest.raises(TypeError):
        sr.segment_rowsum(g, i.long(), 3)
    with pytest.raises(ValueError):
        sr.segment_rowsum(g.t(), torch.zeros((4,), dtype=torch.int32,
                                             device=cuda_device), 3)
    a, aa = torch.zeros((3, 4), device=cuda_device), torch.zeros(3, device=cuda_device)
    with pytest.raises(ValueError):
        bs.buffer_sync(a[:0], aa[:0], g, i.float(), i)  # Ka == 0
    with pytest.raises(TypeError):
        es.embedding_scatter(g, i.float(), i, g.double(), i.float())


def test_training_on_the_card_runs_the_kernels_and_matches_cpu(cuda_device):
    kw = dict(reduced=True, global_batch=32, n_micro=4, seed=3)
    gpu = Session.from_arch("dlrm-ctr", **kw)
    cpu = Session.from_arch("dlrm-ctr", device="cpu", **kw)
    cpu.state = clone_state(gpu.state, "cpu")
    counts = [m.launches for m in (eg, sr, bs, es)]
    steps = 6
    got = gpu.train(steps)
    want = cpu.train(steps)
    launched = [m.launches - c for m, c in zip((eg, sr, bs, es), counts)]
    assert launched == [13 * steps, 5 * steps, steps - 1, steps]
    assert got.summary["overflow_max"] == 0
    np.testing.assert_allclose(got.stats.losses, want.stats.losses, atol=1e-5)
    torch.testing.assert_close(got.state.table.rows.cpu(), want.state.table.rows,
                               rtol=0, atol=1e-5)
    for k, v in want.state.dense.items():
        torch.testing.assert_close(got.state.dense[k].cpu(), v, rtol=0, atol=1e-5)


def test_session_takes_its_own_tables_on_the_card(cuda_device):
    """A tensor made on ``cuda`` lies on ``cuda:0``; the session, made on
    ``cuda``, must take it back (``ingest`` and the ``state`` setter)."""
    sess = Session.from_arch("dlrm-ctr", reduced=True, global_batch=32)
    model, table = sess.weights()
    assert table.rows.device == torch.device("cuda:0")
    sess.ingest(model.state_dict(), table)
    sess.state = clone_state(sess.state)
    assert sess.train(1).summary["steps"] == 1
