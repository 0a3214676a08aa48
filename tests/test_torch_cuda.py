"""The port on the card: the hand-written CUDA kernels, the serving paths
(DLRM embeddings, dense-LM prefill and decode), the training paths (DLRM
and HSTU) and the host and cached embedding tiers.

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

from repro_torch.api import Session, resolve_stream
from repro_torch.core.consistency import add_rows_in_order, build_reference_step
from repro_torch.core.embedding.routing import SENTINEL
from repro_torch.core.store import FetchPlan
from repro_torch.kernels import buffer_sync as bs
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import embedding_scatter as es
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hstu_attention as ha
from repro_torch.kernels import segment_rowsum as sr
from repro_torch.data.pipeline import make_cluster_transform, stage_to_device
from repro_torch.launch.build import make_loss_fn
from repro_torch.train import clone_state, constant_lr

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


def _gathers_once(table, idx):
    """The kernel's rows, after checking that the call launched once (none
    for no rows) and that a second call gives the same bits."""
    before = eg.launches
    got = eg.embedding_gather(table, idx)
    torch.cuda.synchronize()
    assert eg.launches == before + (idx.numel() > 0)
    assert torch.equal(got, eg.embedding_gather(table, idx))
    return got


@pytest.mark.parametrize("rows,d,n", [(64, 128, 37), (100, 96, 200), (32, 33, 8),
                                      (1000, 1, 513), (7, 128, 1), (5, 16, 0),
                                      # few wide rows: a row split over warps
                                      (1000, 5120, 1), (1000, 5120, 8),
                                      (1000, 5120, 32), (1000, 5120, 33),
                                      (300, 5121, 40),  # no 16-byte vectors
                                      (5000, 128, 20000)])  # many narrow rows
def test_kernel_bitwise_equals_plain(cuda_device, rows, d, n):
    table, idx = _case(rows, d, n, seed=rows + n)
    t = torch.from_numpy(table).to(cuda_device)
    i = torch.from_numpy(idx).to(cuda_device)
    before = eg.launches
    got = dispatch.gather_rows(t, i)
    torch.cuda.synchronize()
    assert eg.launches == before + (n > 0)
    assert torch.equal(got, ref.gather_rows_ref(t, i))
    # a contiguous view 4 bytes off 16-byte alignment takes the element path
    flat = torch.cat([t.new_zeros(1), t.reshape(-1)])
    shifted = flat[1:].view(rows, d)
    assert torch.equal(_gathers_once(shifted, i), ref.gather_rows_ref(shifted, i))
    # every slot a sentinel: zero rows, nothing read
    sentinels = torch.full((n,), SENTINEL, dtype=torch.int32, device=cuda_device)
    assert torch.equal(_gathers_once(t, sentinels), torch.zeros_like(got))


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
        # the CPU plain version in the kernel's chunk order
        assert torch.equal(got.cpu(), ref.segment_rowsum_chunked_ref(
            torch.from_numpy(grads), torch.from_numpy(ids), s, chunk=sr.CHUNK))
        want = ref.segment_rowsum_ref(g, i, s)  # atomics on the card
        if integer:
            assert torch.equal(got, want)
        else:
            # the atomics add in another order: reordering an f32 sum of n
            # terms moves it by about sqrt(n) * 6e-8 of its sum of magnitudes
            mag = ref.segment_rowsum_ref(g.abs(), i, s)
            assert bool(((got - want).abs() <= 1e-6 * mag + 1e-6).all())


@pytest.mark.parametrize("run", [5400, sr.CHUNK - 1, sr.CHUNK, sr.CHUNK + 1, 3 * sr.CHUNK])
def test_segment_rowsum_splits_long_runs(cuda_device, run):
    """A hot key: ``run`` positions of one id among singles and drops, at
    D = 512 (HSTU's width). Bit for bit against the chunk-ordered plain
    version; against the input-order one on integer grads (exact sums) and
    whenever the run is one chunk; the same bits twice and off alignment."""
    rng = np.random.default_rng(run)
    s, n = 700, run + 900
    ids = rng.integers(0, s, size=n)
    ids[rng.permutation(n)[:run]] = 3
    ids[rng.random(n) < 0.05] = SENTINEL
    for integer in (True, False):
        grads = rng.normal(size=(n, 512)).astype(np.float32)
        if integer:
            grads = np.round(grads * 8).astype(np.float32)
        gc, ic = torch.from_numpy(grads), torch.from_numpy(ids.astype(np.int32))
        g, i = gc.to(cuda_device), ic.to(cuda_device)
        got = sr.segment_rowsum(g, i, s)
        torch.cuda.synchronize()
        assert torch.equal(got, sr.segment_rowsum(g, i, s))
        assert torch.equal(got, sr.segment_rowsum(_misaligned(g), i, s))
        assert torch.equal(got.cpu(), ref.segment_rowsum_chunked_ref(gc, ic, s, chunk=sr.CHUNK))
        if integer or int((ids == 3).sum()) <= sr.CHUNK:
            assert torch.equal(got.cpu(), ref.segment_rowsum_ref(gc, ic, s))


def test_segment_rowsum_parts_compose(cuda_device):
    """The op's four parts, called one by one (as chip_smoke times them),
    give the op's bits."""
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 50, size=3000).astype(np.int32)
    ids[:700] = 7
    g = torch.from_numpy(rng.normal(size=(3000, 96)).astype(np.float32)).to(cuda_device)
    i = torch.from_numpy(ids).to(cuda_device)
    sorted_ids, perm = sr.sort_ids(i)
    starts = sr.find_starts(sorted_ids, 50)
    runs = torch.bincount(i.long(), minlength=50)
    assert torch.equal(starts[1:] - starts[:-1], runs)
    out, partial = sr.sum_chunks(g, sorted_ids, perm, starts, 50)
    assert partial.shape == (-(-3000 // sr.CHUNK), 96)
    assert torch.equal(sr.combine(out, partial, sorted_ids, starts), sr.segment_rowsum(g, i, 50))


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


@pytest.mark.parametrize("r,n,d,valid", [(100, 37, 128, None), (50, 50, 33, None),
                                         (7, 0, 4, None), (1000, 300, 1, None),
                                         (5000, 2000, 128, 0.1), (5000, 1001, 33, 0.01)])
def test_embedding_scatter_kernel_equals_plain(cuda_device, r, n, d, valid):
    """Bit for bit against the plain version; ``valid`` is the share of
    in-range slots where most are sentinels (a write-back's padding)."""
    rng = np.random.default_rng(r + n)
    table = torch.from_numpy(rng.normal(size=(r, d)).astype(np.float32)).to(cuda_device)
    accum = torch.from_numpy(rng.random(r).astype(np.float32)).to(cuda_device)
    idx = rng.permutation(r)[:n].astype(np.int64)
    if valid is None:
        idx[::4] = r
        idx[1::9] = SENTINEL
    else:
        idx[rng.random(n) >= valid] = SENTINEL
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


def _hstu_case(dev, b, t, h, dqk, dv, strided, seed):
    g = torch.Generator(dev).manual_seed(seed)
    if strided:  # the layer's q, k, v: column slices of one (..., 2dqk + 2dv) tensor
        mixed = torch.empty((b, t, h, 2 * dqk + 2 * dv), device=dev).normal_(generator=g)
        _, v, q, k = torch.split(mixed, [dv, dv, dqk, dqk], dim=-1)
    else:
        q, k = (torch.empty((b, t, h, dqk), device=dev).normal_(generator=g) for _ in "qk")
        v = torch.empty((b, t, h, dv), device=dev).normal_(generator=g)
    do = torch.empty((b, t, h, dv), device=dev).normal_(generator=g)
    return q, k, v, do


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,h,dqk,dv,strided", [
    (2, 33, 2, 16, 8, True), (1, 64, 3, 48, 96, True), (2, 130, 2, 128, 128, False),
    (1, 1, 2, 32, 32, True), (3, 17, 1, 5, 3, False), (2, 65, 2, 128, 128, True),
    (1, 65, 2, 5, 3, True), (2, 65, 2, 48, 48, True), (1, 129, 2, 48, 96, True),
    (2, 129, 1, 128, 128, True)])
def test_hstu_attention_kernels_equal_plain(cuda_device, b, t, h, dqk, dv, strided,
                                            causal):
    """Forward and backward within 1e-5 of each output's sum of magnitudes
    plus 1e-7 (the two add in different orders; every product is 3xTF32 on
    the tensor cores), and the same bits on two runs."""
    q, k, v, do = _hstu_case(cuda_device, b, t, h, dqk, dv, strided, seed=t + dqk)
    before = (ha.launches_fwd, ha.launches_bwd)
    out = ha.hstu_attention_fwd(q, k, v, causal)
    grads = ha.hstu_attention_bwd(q, k, v, do, causal)
    again = ha.hstu_attention_fwd(q, k, v, causal), ha.hstu_attention_bwd(q, k, v, do, causal)
    torch.cuda.synchronize()
    assert (ha.launches_fwd, ha.launches_bwd) == (before[0] + 2, before[1] + 2)
    assert torch.equal(out, again[0])
    assert all(torch.equal(a, c) for a, c in zip(grads, again[1]))
    out_mag, grad_mags = ref.hstu_attention_magnitudes(q, k, v, do, causal)
    want = ref.hstu_attention_ref(q, k, v, causal)
    assert out.shape == want.shape and out.is_contiguous()
    assert bool(((out - want).abs() <= 1e-5 * out_mag + 1e-7).all())
    for got, w, mag in zip(grads, ref.hstu_attention_bwd_ref(q, k, v, do, causal),
                           grad_mags):
        assert got.shape == w.shape
        assert bool(((got - w).abs() <= 1e-5 * mag + 1e-7).all())


def test_hstu_attention_autograd_runs_the_kernels(cuda_device):
    q, k, v, do = _hstu_case(cuda_device, 2, 40, 2, 16, 16, True, seed=1)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    before = (ha.launches_fwd, ha.launches_bwd)
    dispatch.hstu_attention(*leaves).backward(do)
    torch.cuda.synchronize()
    assert (ha.launches_fwd, ha.launches_bwd) == (before[0] + 1, before[1] + 1)
    for leaf, w in zip(leaves, ha.hstu_attention_bwd(q, k, v, do)):
        assert torch.equal(leaf.grad, w)


def test_hstu_attention_raises_rather_than_falling_back(cuda_device):
    q, k, v, do = _hstu_case(cuda_device, 1, 8, 2, 16, 16, False, seed=2)
    with pytest.raises(TypeError):
        dispatch.hstu_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError):
        dispatch.hstu_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        ha.hstu_attention_bwd(q, k, v, do.cpu())
    with pytest.raises(ValueError):  # head dims above 128
        ha.hstu_attention_fwd(*(torch.zeros((1, 4, 1, 129), device=cuda_device),) * 3)
    with pytest.raises(ValueError):  # d not the unit-stride axis
        ha.hstu_attention_fwd(q.transpose(1, 3), k.transpose(1, 3), v.transpose(1, 3))


@pytest.mark.parametrize("rows,d,n", [(300, 512, 200),
                                      # few wide rows: a row split over warps
                                      (1000, 5120, 1), (1000, 5120, 8),
                                      (1000, 5120, 32), (1000, 5120, 33),
                                      (300, 5121, 40),  # no 16-byte vectors
                                      (5000, 128, 20000)])  # many narrow rows
def test_bf16_gather_equals_plain(cuda_device, rows, d, n):
    g = torch.Generator(cuda_device).manual_seed(4)
    t = torch.empty((rows, d), device=cuda_device).normal_(generator=g).bfloat16()
    idx = torch.randint(-2, rows + 5, (n,), device=cuda_device, generator=g,
                        dtype=torch.int32)
    idx[1::7] = SENTINEL
    assert torch.equal(_gathers_once(t, idx), ref.gather_rows_ref(t, idx))
    odd = t[:, :33].contiguous()  # rows of 66 bytes: the element path
    assert torch.equal(_gathers_once(odd, idx), ref.gather_rows_ref(odd, idx))
    flat = torch.cat([t.new_zeros(2), t.reshape(-1)])  # 4 bytes off alignment
    shifted = flat[2:].view(rows, d)
    assert torch.equal(_gathers_once(shifted, idx), ref.gather_rows_ref(shifted, idx))
    sentinels = torch.full((n,), SENTINEL, dtype=torch.int32, device=cuda_device)
    assert torch.equal(_gathers_once(t, sentinels), torch.zeros((n, d), dtype=t.dtype,
                                                                device=cuda_device))


def test_hstu_training_on_the_card_runs_the_kernels_and_matches_cpu(cuda_device):
    """``hstu-reduced`` (2 layers, N = 4): 2 x 2 x 4 forward and 2 x 4
    backward launches a step (each layer's forward runs again in the
    backward), and the CPU's trajectory within 1e-5, at the rowwise-Adagrad
    step and AdamW eps of the CPU parity tests (tests/test_torch_train.py
    says why: HSTU's training is chaotic at the default step sizes)."""
    from repro_torch.configs.base import OptimizerConfig

    kw = dict(reduced=True, global_batch=16, n_micro=4, seed=3,
              opt_cfg=OptimizerConfig(eps=1e-6))
    gpu = Session.from_arch("hstu-industrial", **kw)
    cpu = Session.from_arch("hstu-industrial", device="cpu", **kw)
    for s in (gpu, cpu):
        s.workload.engine.sparse_lr = 0.002
    cpu.state = clone_state(gpu.state, "cpu")
    before = (ha.launches_fwd, ha.launches_bwd)
    steps = 4
    got, want = gpu.train(steps), cpu.train(steps)
    assert (ha.launches_fwd - before[0], ha.launches_bwd - before[1]) == \
        (16 * steps, 8 * steps)
    assert got.summary["overflow_max"] == 0
    np.testing.assert_allclose(got.stats.losses, want.stats.losses, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.state.table.rows.cpu(), want.state.table.rows,
                               rtol=0, atol=1e-5)
    for k, v in want.state.dense.items():
        torch.testing.assert_close(got.state.dense[k].cpu(), v, rtol=0, atol=1e-5)


def _flash_case(dev, b, tq, tk, h, kv, hd, dtype, seed):
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((b, tq, h, hd), device=dev, generator=g).to(dtype)
    k = torch.randn((b, tk, kv, hd), device=dev, generator=g).to(dtype)
    v = torch.randn((b, tk, kv, hd), device=dev, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tq,tk,h,kv,hd,causal", [
    (1, 1, 1, 2, 1, 16, True), (2, 33, 33, 4, 1, 80, True), (1, 130, 130, 4, 4, 160, True),
    (1, 33, 100, 4, 2, 64, False), (2, 70, 70, 2, 2, 8, False), (1, 65, 65, 2, 1, 256, True)])
def test_flash_attention_kernel_equals_plain(cuda_device, b, tq, tk, h, kv, hd, causal,
                                             dtype):
    """Within ``ref.flash_attention_bound`` of the plain version (f32: 1e-5
    of each output's sum of |w v| + 1e-7; bf16: 2**-8 of it plus one bf16
    ulp, as the kernel rounds the weights to bf16), the same bits twice."""
    q, k, v = _flash_case(cuda_device, b, tq, tk, h, kv, hd, dtype, seed=tq + hd)
    before = fa.launches
    got = dispatch.flash_attention(q, k, v, causal)
    again = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    assert got.dtype == dtype and got.shape == (b, tq, h, hd) and got.is_contiguous()
    assert torch.equal(got, again)
    want = ref.flash_attention_ref(q, k, v, causal)
    err = (got.float() - want.float()).abs()
    assert bool((err <= ref.flash_attention_bound(q, k, v, want, causal)).all())


@pytest.mark.parametrize("hd", fa.WGMMA_HEAD_DIMS)
def test_flash_attention_wgmma_kernel_equals_plain(cuda_device, hd):
    """The main-path kernel at every head dim it takes: causal and not, T 1,
    33 and 2048 with H/KV 4, Tq 33 against Tk 100; within
    ``ref.flash_attention_bound``, the same bits twice, and only its own
    counter moves."""
    cases = [(1, 1, 1, 4, 1), (2, 33, 33, 4, 1), (1, 2048, 2048, 4, 1), (2, 33, 100, 4, 1),
             (1, 300, 300, 8, 8)]
    for b, tq, tk, h, kv in cases:
        for causal in (True, False):
            q, k, v = _flash_case(cuda_device, b, tq, tk, h, kv, hd, torch.bfloat16,
                                  seed=tq + hd)
            assert fa.variant(q, k, v) == "wgmma"
            before = (fa.launches_wgmma, fa.launches_simple, fa.launches)
            got = dispatch.flash_attention(q, k, v, causal)
            again = fa.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            assert (fa.launches_wgmma, fa.launches_simple, fa.launches) == (
                before[0] + 2, before[1], before[2] + 2)
            assert got.shape == (b, tq, h, hd) and got.is_contiguous()
            assert torch.equal(got, again)
            want = ref.flash_attention_ref(q, k, v, causal)
            err = (got.float() - want.float()).abs()
            assert bool((err <= ref.flash_attention_bound(q, k, v, want, causal)).all()), (
                b, tq, tk, h, kv, causal, float(err.max()))


def test_flash_attention_wgmma_reads_strided_views(cuda_device):
    """q, k and v as column slices of one wider tensor whose rows keep
    16-byte alignment (as a fused projection makes them): the main-path
    kernel takes them in place, and agrees with the general kernel's bound."""
    g = torch.Generator(cuda_device).manual_seed(5)
    wide = torch.randn((2, 200, 4, 3 * 160 + 8), device=cuda_device,
                       generator=g).to(torch.bfloat16)
    q, k, v = wide[..., 8:168], wide[..., 168:328], wide[..., 328:488]
    assert not q.is_contiguous() and fa.variant(q, k, v) == "wgmma"
    for causal in (True, False):
        before = fa.launches_wgmma
        got = fa.flash_attention(q, k, v, causal)
        assert fa.launches_wgmma == before + 1
        assert torch.equal(got, fa.flash_attention(q.contiguous(), k.contiguous(),
                                                   v.contiguous(), causal))
        want = ref.flash_attention_ref(q, k, v, causal)
        err = (got.float() - want.float()).abs()
        assert bool((err <= ref.flash_attention_bound(q, k, v, want, causal)).all())
        simple = fa.flash_attention_simple(q, k, v, causal)
        assert bool(((simple.float() - want.float()).abs()
                     <= ref.flash_attention_bound(q, k, v, want, causal)).all())


def test_flash_attention_layout_does_not_pick_the_kernel(cuda_device):
    """Views a TMA map cannot describe (off 16-byte alignment, a row stride
    of 164, heads outside positions) are copied for the wgmma kernel, so the
    same values give the contiguous layout's bits."""
    q, k, v = _flash_case(cuda_device, 2, 70, 70, 4, 1, 160, torch.bfloat16, seed=6)
    layouts = {
        "off alignment": lambda x: torch.zeros(x.numel() + 3, dtype=x.dtype,
                                               device=x.device)[3:].view(x.shape).copy_(x),
        "stride 164": lambda x: torch.zeros((*x.shape[:-1], 164), dtype=x.dtype,
                                            device=x.device)[..., :160].copy_(x),
        "heads outside": lambda x: x.transpose(1, 2).contiguous().transpose(1, 2),
    }
    for causal in (True, False):
        want = fa.flash_attention(q, k, v, causal)
        for name, layout in layouts.items():
            views = [layout(x) for x in (q, k, v)]
            assert not fa.tma_ok(views[0]), name
            before = (fa.launches_wgmma, fa.launches_simple)
            got = fa.flash_attention(*views, causal)
            assert (fa.launches_wgmma, fa.launches_simple) == (before[0] + 1, before[1]), name
            assert torch.equal(got, want), name


def test_flash_attention_reads_strided_views(cuda_device):
    """q, k and v as column slices of one wider tensor, 3 elements off its
    rows' start (so the 16-byte loads are off), in both types."""
    g = torch.Generator(cuda_device).manual_seed(4)
    for t in (torch.float32, torch.bfloat16):
        wide = torch.randn((2, 50, 4, 3 * 40 + 3), device=cuda_device, generator=g).to(t)
        q, k, v = wide[..., 3:43], wide[..., 43:83], wide[..., 83:123]
        assert q.stride(1) == 4 * 123
        got = fa.flash_attention(q, k, v, True)
        want = ref.flash_attention_ref(q, k, v, True)
        err = (got.float() - want.float()).abs()
        assert bool((err <= ref.flash_attention_bound(q, k, v, want, True)).all())


def test_flash_attention_raises_rather_than_falling_back(cuda_device):
    q, k, v = _flash_case(cuda_device, 1, 8, 8, 4, 2, 16, torch.float32, seed=1)
    before = fa.launches
    bad = [
        (q.half(), k.half(), v.half()),                     # a type it does not take
        (q, k.bfloat16(), v),                                # mixed types
        (q, k.cpu(), v),                                     # a CPU tensor among CUDA ones
        (q.transpose(1, 3), k, v),                           # hd not the unit stride
        (q[:, :, :3], k, v),                                 # 3 heads over 2 kv heads
        _flash_case(cuda_device, 1, 8, 8, 2, 1, 264, torch.float32, seed=2),  # hd > 256
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            dispatch.flash_attention(*args)
    assert fa.launches == before


def test_lm_serving_on_the_card_runs_the_kernel_and_matches_cpu(cuda_device):
    """Reduced stablelm-12b (f32): the same tokens on the card as on the
    CPU from the same weights, one flash_attention launch per layer (the
    prefill; decode attention is plain), three gathers per lookup."""
    gpu = Session.from_arch("stablelm-12b", reduced=True, seed=2)
    cpu = Session.from_arch("stablelm-12b", reduced=True, seed=2, device="cpu")
    params, table = gpu.lm_weights()
    cpu.ingest({k: v.cpu() for k, v in params.items()},
               type(table)(table.rows.cpu(), table.accum.cpu()))
    before = (fa.launches, eg.launches)
    got = gpu.serve(batch=2, prompt_len=40, gen=5)
    want = cpu.serve(batch=2, prompt_len=40, gen=5)
    assert (fa.launches - before[0], eg.launches - before[1]) == (2, 3 * 5)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.summary["device"].startswith("cuda")


@pytest.mark.parametrize("d", [1, 64])
def test_reference_sum_gives_the_cpu_bits_on_the_card(cuda_device, d):
    """The reference trainer's table-gradient sum adds each key's rows in
    input order on the card too: the CPU ``index_add_``'s bits, hot keys
    included."""
    rng = np.random.default_rng(d)
    idx = np.concatenate([rng.integers(0, 37, size=3000), np.full(300, 5)])
    rows = (rng.normal(size=(idx.size, d)) * rng.uniform(0, 1e3, (idx.size, 1))).astype(
        np.float32)
    grad = rng.normal(size=(37, d)).astype(np.float32)
    want = torch.from_numpy(grad.copy()).index_add_(0, torch.from_numpy(idx),
                                                    torch.from_numpy(rows))
    got = torch.from_numpy(grad).to(cuda_device)
    add_rows_in_order(got, torch.from_numpy(idx).to(cuda_device),
                      torch.from_numpy(rows).to(cuda_device))
    assert torch.equal(got.cpu(), want)


def test_reference_step_gives_the_same_bits_twice_on_the_card(cuda_device):
    """The reference trainer at hstu-reduced, two steps from one state, run
    twice: the same bits (its sum has a fixed order on the card)."""
    sess = Session.from_arch("hstu-industrial", reduced=True, global_batch=16, n_micro=4,
                             seed=1)
    wl = sess.workload
    step = build_reference_step(make_loss_fn(wl.cfg), sess.optimizer,
                                constant_lr(sess.opt_cfg.lr, cuda_device), wl.n_micro,
                                sparse_lr=wl.engine.sparse_lr)
    transform = make_cluster_transform(wl.n_micro, wl.npcfg.clustering)
    stream = resolve_stream(wl, sess.seed)
    batches = [stage_to_device({"keys": transform(next(stream))["keys"]}, cuda_device)
               for _ in range(2)]
    finals = []
    for _ in range(2):
        state = clone_state(sess.state)
        with torch.no_grad():
            for b in batches:
                state, _ = step(state, b)
        finals.append(state)
    a, b = finals
    assert torch.equal(a.table.rows, b.table.rows)
    assert torch.equal(a.table.accum, b.table.accum)
    assert all(torch.equal(a.dense[k], b.dense[k]) for k in a.dense)


# ---------------------------------------------------------------------------
# the host and cached tiers on the card
# ---------------------------------------------------------------------------

TIER_KW = dict(reduced=True, global_batch=32, n_micro=4, seed=3)


def _tier_sessions(*tiers, **kw):
    """Sessions on the card over ``tiers``, all from one initial state."""
    init = clone_state(Session.from_arch("dlrm-ctr", **TIER_KW).state)
    out = []
    for tier in tiers:
        sess = Session.from_arch("dlrm-ctr", store=tier, **TIER_KW, **kw)
        sess.state = clone_state(init)
        out.append(sess)
    return out


def test_host_and_cached_tiers_give_the_device_tiers_bits(cuda_device):
    """Staging over the side stream (host tier) and the cache's kernel
    gathers and scatters (cached tier) replay the device tier bit for bit:
    losses, master rows and adagrad state."""
    runs = [s.train(6) for s in _tier_sessions("device", "host", "cached")]
    want = runs[0]
    for rep in runs[1:]:
        assert rep.stats.losses == want.stats.losses, rep.summary["store"]
        assert torch.equal(rep.state.table.rows, want.state.table.rows)
        assert torch.equal(rep.state.table.accum, want.state.table.accum)
        assert rep.state.table.rows.is_cuda  # released to the card
        assert rep.summary["h2d_copy_ms"] > 0 and rep.summary["d2h_copy_ms"] > 0


def test_cached_tier_under_eviction_replays_the_host_tier(cuda_device):
    host, = _tier_sessions("host")
    want = host.train(6)
    for policy in ("freq", "lru", "oracle"):
        cached, = _tier_sessions("cached", cache_rows=32, cache_chunk_rows=4,
                                 cache_policy=policy)
        got = cached.train(6)
        assert got.stats.store_metrics["cache_evictions"] > 0
        assert got.stats.losses == want.stats.losses, policy
        assert torch.equal(got.state.table.rows, want.state.table.rows), policy


def test_host_master_is_pinned_and_stages_the_device_gathers_bits(cuda_device):
    from repro_torch.core.store import HostStore

    sess = Session.from_arch("dlrm-ctr", **TIER_KW)
    table, spec = sess.state.table, sess.workload.spec
    store = HostStore.from_device_table(sess.workload.engine, table)
    assert store.rows.is_pinned() and store.accum.is_pinned()
    assert not store.rows.is_cuda
    keys = np.unique(np.random.default_rng(1).integers(0, spec.padded_rows, 300))
    keys = np.pad(keys.astype(np.int32), (0, 64), constant_values=SENTINEL)
    buf = store.stage(keys)
    idx = torch.from_numpy(np.where(keys == SENTINEL, spec.padded_rows, keys)
                           .astype(np.int32)).to(cuda_device)
    assert buf.rows.is_cuda and torch.equal(buf.rows, ref.gather_rows_ref(table.rows, idx))
    assert torch.equal(buf.accum, ref.gather_rows_ref(table.accum[:, None], idx)[:, 0])
    torch.cuda.synchronize()
    assert store.copies.times()["h2d_copy_ms"] > 0


def test_cached_tier_kernels_run_and_equal_the_plain_versions(cuda_device):
    """The cached tier's device work on the card (assembly gathers of the
    rows and of the D = 1 adagrad state, admission pulls, cache scatters,
    eviction pulls) against the same store on the CPU, bit for bit: the
    kernels' counters move and every buffer, the cache and the master
    agree."""
    from repro_torch.core.store import CachedStore

    gpu_sess = Session.from_arch("dlrm-ctr", **TIER_KW)
    cpu_sess = Session.from_arch("dlrm-ctr", device="cpu", **TIER_KW)
    table = gpu_sess.state.table
    kw = dict(capacity=64, chunk_rows=4, miss_bucket=8, policy="lru")
    gpu = CachedStore.from_device_table(gpu_sess.workload.engine, table, **kw)
    cpu = CachedStore.from_device_table(cpu_sess.workload.engine,
                                        clone_state(gpu_sess.state, "cpu").table, **kw)
    rng = np.random.default_rng(2)
    spec = gpu_sess.workload.spec
    before = (eg.launches, es.launches)
    for step in range(6):
        keys = np.unique(rng.integers(0, spec.padded_rows, 40)).astype(np.int32)
        keys = np.pad(keys, (0, 48 - keys.size), constant_values=SENTINEL)
        plan = FetchPlan(None, keys)
        got, want = gpu.retrieve(plan), cpu.retrieve(plan)
        assert torch.equal(got.rows.cpu(), want.rows)
        assert torch.equal(got.accum.cpu(), want.accum)
        upd = rng.normal(size=want.rows.shape).astype(np.float32)
        acc = rng.random(want.accum.shape[0]).astype(np.float32)
        for store, buf in ((gpu, got), (cpu, want)):
            dev = buf.rows.device
            store.commit(buf._replace(rows=torch.from_numpy(upd).to(dev),
                                      accum=torch.from_numpy(acc).to(dev)), plan)
    assert gpu.evictions == cpu.evictions > 0
    assert torch.equal(gpu.cache_rows.cpu(), cpu.cache_rows)
    assert torch.equal(gpu.cache_accum.cpu(), cpu.cache_accum)
    gathers, scatters = eg.launches - before[0], es.launches - before[1]
    assert gathers >= 6 * 4 and scatters >= 6 * 2
    assert torch.equal(gpu.export_table().rows.cpu(), cpu.export_table().rows)
    assert gpu.rows.is_pinned()


def test_accum_gather_at_one_column_runs_the_kernel(cuda_device):
    g = torch.Generator(cuda_device).manual_seed(0)
    accum = torch.rand(5000, device=cuda_device, generator=g)
    idx = torch.randint(-3, 5010, (777,), device=cuda_device, generator=g,
                        dtype=torch.int32)
    before = eg.launches
    got = dispatch.gather_rows(accum.view(-1, 1), idx)
    assert eg.launches == before + 1
    assert torch.equal(got, ref.gather_rows_ref(accum.view(-1, 1), idx))


def test_cached_tier_serves_exactly_on_the_card(cuda_device):
    sess, = _tier_sessions("cached")
    sess.train(2)
    before = (eg.launches, es.launches)
    rep = sess.serve_embeddings(num_requests=64, max_batch=16, head="dlrm",
                                check_exact=True)
    assert rep.summary["exact"] == 1 and rep.summary["store"] == "frozen-cached"
    assert rep.summary["cache_hits"] > 0
    assert eg.launches > before[0] and es.launches > before[1]


# ---------------------------------------------------------------------------
# the async stage executor and the sparse-comm modes on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["device", "host", "cached"])
def test_async_stages_give_the_sync_bits_on_the_card(cuda_device, tier):
    """Worker threads, the executor's stream and the event handoffs replay
    the synchronous loop bit for bit at lookahead 1 and 3: losses, master
    rows and adagrad state."""
    for lookahead in (1, 3):
        sync, = _tier_sessions(tier, prefetch_ahead=lookahead)
        want = sync.train(6)
        before = (eg.launches, bs.launches)
        asyn, = _tier_sessions(tier, prefetch_ahead=lookahead, async_stages="on")
        got = asyn.train(6)
        assert got.summary["async_stages"] and not want.summary["async_stages"]
        assert got.stats.losses == want.stats.losses, lookahead
        assert torch.equal(got.state.table.rows, want.state.table.rows)
        assert torch.equal(got.state.table.accum, want.state.table.accum)
        assert eg.launches > before[0] and bs.launches >= before[1] + 5


@pytest.mark.parametrize("tier", ["host", "cached"])
def test_forced_race_repairs_on_the_card(cuda_device, tier):
    """Window 5's retrieve held until commit 3 is submitted (lookahead 3):
    the deferred repairs run as extra buffer_sync launches and the run
    keeps the synchronous bits."""
    import threading

    gate, events = threading.Event(), []

    def on_retrieve_start(w):
        if w == 5:
            assert gate.wait(timeout=60)
        events.append(("retrieve", w))

    def on_commit_submit(epoch):
        events.append(("commit_submit", epoch))
        if epoch == 3:
            gate.set()

    sync, = _tier_sessions(tier, prefetch_ahead=3)
    want = sync.train(7)
    sess, = _tier_sessions(tier, prefetch_ahead=3, async_stages="on")
    driver = sess.strategy.build_driver(
        sess.fns, resolve_stream(sess.workload, sess.seed), sess.workload,
        stage_hooks={"retrieve_start": on_retrieve_start,
                     "commit_submit": on_commit_submit})
    before = bs.launches
    state, stats = driver.run(sess._take_state(), 7)
    assert stats.losses == want.stats.losses
    assert torch.equal(state.table.rows, want.state.table.rows)
    assert torch.equal(state.table.accum, want.state.table.accum)
    r5 = events.index(("retrieve", 5))
    assert ("commit_submit", 3) in events[:r5]
    assert bs.launches - before > 6  # more than one sync a step: repairs ran


@pytest.mark.parametrize("async_on", ["off", "on"])
def test_pack_and_int8_on_the_card(cuda_device, async_on):
    """``pack`` crosses the bus with narrow index vectors and casts them
    back on the card: the ``off`` bits, fewer index bytes. ``int8`` runs
    with its ledger and finite losses."""
    off, pack, int8 = (
        _tier_sessions("cached", cache_rows=64, cache_chunk_rows=4,
                       sparse_comm=m, async_stages=async_on)[0]
        for m in ("off", "pack", "int8"))
    want, got, q = off.train(6), pack.train(6), int8.train(6)
    assert got.stats.losses == want.stats.losses
    assert torch.equal(got.state.table.rows, want.state.table.rows)
    assert torch.equal(got.state.table.accum, want.state.table.accum)
    assert got.summary["idx_bytes"] < want.summary["idx_bytes"]
    assert got.summary["wire_bytes"] < want.summary["wire_bytes"]
    assert all(np.isfinite(q.stats.losses))
    assert q.summary["comm_rows_synced"] + q.summary["comm_rows_deferred"] > 0
