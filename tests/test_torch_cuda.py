"""The port on the card: the hand-written CUDA kernels, the serving paths
(DLRM embeddings, dense-LM prefill and decode), the training paths (DLRM,
HSTU and FuXi, whose attention runs the tf32x3 flash_attention forward and
backward kernels, and the dense LMs: bf16 at a wgmma head dim through the
wgmma forward with its lse, and at hd 64, 80, 128 and 160 the wgmma
backward, else the general one),
the host and cached embedding tiers, checkpoints (chunked writes from
the card, an in-place restore, the save's time kept out of the steps), and
faults (a fault at every store site, recovered to the fault-free bits; a
preemption by a real signal, resumed to the uninterrupted run's bits), and
the MoE (its layer on the card against the CPU and the same bits twice; a
bf16 MoE LM's checkpoint resumed bit for bit), and Mamba2 (the chunked SSD
against the f64 recurrence, a prefill and a decode step against the longer
prefill, a finite step at the published chunk), and the encoder-decoder
(the wgmma kernels at hd 64 without a mask, Tq != Tk; a bf16 prefill and a
decode step against the longer prefill), and the VLM (a narrow bf16 pixtral
at hd 160 served and trained against the CPU).

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one (the kernels have no CPU mode). The file imports no jax, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.api import Session, resolve_stream
from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.registry import ArchSpec, get_arch
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
from repro_torch.launch.build import assemble_workload, make_loss_fn
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


FLASH_TF32X3_CASES = [(1, 1, 1, 2, 1, 16, True), (2, 33, 33, 4, 1, 80, True),
                      (1, 33, 100, 4, 2, 64, False), (2, 70, 70, 2, 2, 8, False),
                      (1, 512, 512, 4, 4, 64, True), (1, 512, 512, 4, 4, 64, False),
                      (1, 512, 512, 4, 1, 128, True), (1, 512, 512, 4, 1, 128, False),
                      (2, 33, 100, 4, 4, 64, True), (2, 33, 100, 4, 1, 128, True),
                      (2, 33, 100, 4, 1, 64, False), (1, 100, 33, 2, 2, 5, True)]


@pytest.mark.parametrize("b,tq,tk,h,kv,hd,causal", FLASH_TF32X3_CASES)
def test_flash_attention_tf32x3_kernel_equals_plain(cuda_device, b, tq, tk, h, kv, hd,
                                                    causal):
    """The tf32x3 kernel (f32 at hd <= 128) within ``ref.flash_attention_bound``
    of the plain version, its lse within ``ref.flash_attention_lse_bound``;
    the same bits twice and with or without the lse; only its counter moves."""
    q, k, v = _flash_case(cuda_device, b, tq, tk, h, kv, hd, torch.float32, seed=tq + hd)
    assert fa.variant(q, k, v) == fa.lse_variant(q, k, v) == "tf32x3"
    before = (fa.launches_tf32x3, fa.launches_simple, fa.launches_wgmma, fa.launches)
    got = dispatch.flash_attention(q, k, v, causal)
    again = fa.flash_attention(q, k, v, causal)
    out, lse = fa.flash_attention_lse(q, k, v, causal)
    torch.cuda.synchronize()
    assert (fa.launches_tf32x3, fa.launches_simple, fa.launches_wgmma, fa.launches) == (
        before[0] + 3, before[1], before[2], before[3] + 3)
    assert got.shape == (b, tq, h, hd) and got.is_contiguous()
    assert torch.equal(got, again) and torch.equal(got, out)
    want = ref.flash_attention_ref(q, k, v, causal)
    err = (got - want).abs()
    assert bool((err <= ref.flash_attention_bound(q, k, v, want, causal)).all()), \
        float(err.max())
    lse_want = ref.flash_attention_lse_ref(q, k, causal)
    assert bool(((lse - lse_want).abs()
                 <= ref.flash_attention_lse_bound(q, k, lse_want, causal)).all())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_tf32x3_holds_the_bound_on_same_sign_values(cuda_device, causal):
    """Scores of std ~4 and v shifted by 2 at FuXi's T and hd: MMA sums whose
    terms share a sign, which drift when one running sum takes them all
    (the tensor cores truncate), stay within ``ref.flash_attention_bound``."""
    q, k, v = _flash_case(cuda_device, 8, 512, 512, 8, 8, 64, torch.float32, seed=9)
    q, k, v = 2 * q, 2 * k, v + 2
    got = fa.flash_attention(q, k, v, causal)
    want = ref.flash_attention_ref(q, k, v, causal)
    err = (got - want).abs()
    assert bool((err <= ref.flash_attention_bound(q, k, v, want, causal)).all()), \
        float(err.max())


def test_flash_attention_tf32x3_same_bits_in_every_layout(cuda_device):
    """The same values as contiguous tensors and as column slices of wider
    tensors (16-byte aligned, read by cp.async, and 3 elements in, read
    element by element) give the tf32x3 kernel's same bits."""
    q, k, v = _flash_case(cuda_device, 2, 70, 70, 4, 1, 64, torch.float32, seed=8)

    def sliced(x, off):
        wide = torch.zeros((*x.shape[:-1], 64 + off + 4), device=x.device)
        return wide[..., off:off + 64].copy_(x)

    for causal in (True, False):
        want = fa.flash_attention(q, k, v, causal)
        for off in (4, 3):
            views = [sliced(x, off) for x in (q, k, v)]
            before = fa.launches_tf32x3
            got, lse = fa.flash_attention_lse(*views, causal)
            assert fa.launches_tf32x3 == before + 1
            assert torch.equal(got, want), (off, causal)
            assert torch.equal(lse, fa.flash_attention_lse(q, k, v, causal)[1])


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


# hd 160 at T 257 with 4 query heads a kv head, causal and not: two 128-key
# tiles and one row, eight 32-query tiles (the wgmma dk/dv kernel's step
# there) and one row
FLASH_BWD_CASES = [(1, 1, 1, 2, 1, 16, True), (2, 33, 33, 4, 1, 80, True),
                   (1, 130, 130, 4, 4, 160, True), (1, 33, 100, 4, 2, 64, False),
                   (1, 33, 100, 4, 1, 16, True), (2, 70, 70, 2, 2, 8, False),
                   (1, 65, 65, 2, 1, 256, True), (1, 100, 33, 2, 2, 5, True),
                   (2, 257, 257, 8, 2, 160, True), (2, 257, 257, 8, 2, 160, False)]


def _flash_fwd_with_lse(dev, b, tq, tk, h, kv, hd, causal, dtype, seed):
    q, k, v = _flash_case(dev, b, tq, tk, h, kv, hd, dtype, seed)
    out, lse = fa.flash_attention_lse(q, k, v, causal)
    g = torch.Generator(dev).manual_seed(seed + 1)
    do = torch.randn(out.shape, device=dev, generator=g).to(dtype)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tq,tk,h,kv,hd,causal", FLASH_BWD_CASES)
def test_flash_attention_bwd_kernel_equals_plain(cuda_device, b, tq, tk, h, kv, hd, causal,
                                                 dtype):
    """dq, dk and dv within ``ref.flash_attention_bwd_bound`` of the plain
    backward on the same inputs (1e-5 of each gradient's sum of magnitudes
    + 1e-7, plus one bf16 ulp in bf16; the wgmma kernel's bf16 operands
    add 2**-8 of the terms' magnitudes), the same bits twice, one launch a
    call of the kernel ``bwd_variant`` picks (f32 at hd <= 128: tf32x3;
    bf16 at hd 64, 80, 128 and 160: wgmma; the rest: the general one) and
    none of the others."""
    q, k, v, o, lse, do = _flash_fwd_with_lse(cuda_device, b, tq, tk, h, kv, hd, causal,
                                              dtype, seed=tq + hd)
    kind = fa.bwd_variant(q, k, v)
    assert kind == ("tf32x3" if dtype == torch.float32 and hd <= 128 else
                    "wgmma" if dtype == torch.bfloat16 and hd in (64, 80, 128, 160)
                    else "simple")
    counters = ("launches_bwd_tf32x3", "launches_bwd_wgmma", "launches_bwd_simple")
    before = [getattr(fa, c) for c in counters] + [fa.launches_bwd]
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal)
    again = fa.flash_attention_bwd(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    assert [getattr(fa, c) for c in counters] + [fa.launches_bwd] == [
        n + 2 * (c == "launches_bwd_" + kind) for n, c in zip(before, counters)] + [
        before[-1] + 2]
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, causal,
                                           products="bf16" if kind == "wgmma" else "f32")
    for g_, w, bd in zip(got, want, bounds):
        assert g_.shape == w.shape and g_.dtype == w.dtype == dtype
        assert bool(((g_.float() - w.float()).abs() <= bd).all())


FLASH_BWD_TF32X3_CASES = [(1, 1, 1, 2, 1, 16, True), (2, 33, 33, 4, 1, 80, True),
                          (1, 33, 100, 4, 2, 64, False), (1, 33, 100, 4, 1, 16, True),
                          (2, 70, 70, 2, 2, 8, False), (1, 100, 33, 2, 2, 5, True),
                          (1, 512, 512, 4, 4, 64, True), (1, 512, 512, 4, 1, 128, True),
                          (1, 300, 300, 8, 2, 32, False), (2, 130, 260, 4, 4, 64, True)]


@pytest.mark.parametrize("b,tq,tk,h,kv,hd,causal", FLASH_BWD_TF32X3_CASES)
def test_flash_attention_bwd_tf32x3_beside_the_general_kernel(cuda_device, b, tq, tk, h, kv,
                                                              hd, causal):
    """The tf32x3 backward and ``flash_attention_bwd_simple`` (the general
    kernel, forced) on the same f32 inputs: each within
    ``ref.flash_attention_bwd_bound`` of the plain backward, the same bits
    twice, each by its own counter."""
    q, k, v, o, lse, do = _flash_fwd_with_lse(cuda_device, b, tq, tk, h, kv, hd, causal,
                                              torch.float32, seed=tq + hd + 1)
    assert fa.bwd_variant(q, k, v) == "tf32x3"
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, causal)
    for fn, counted in ((fa.flash_attention_bwd, "launches_bwd_tf32x3"),
                        (fa.flash_attention_bwd_simple, "launches_bwd_simple")):
        before = (getattr(fa, counted), fa.launches_bwd)
        got = fn(q, k, v, o, do, lse, causal)
        again = fn(q, k, v, o, do, lse, causal)
        torch.cuda.synchronize()
        assert (getattr(fa, counted), fa.launches_bwd) == (before[0] + 2, before[1] + 2)
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), counted
        for name, g_, w, bd in zip(("dq", "dk", "dv"), got, want, bounds):
            assert g_.is_contiguous() and g_.shape == w.shape
            assert bool(((g_ - w).abs() <= bd).all()), (counted, name,
                                                        float((g_ - w).abs().max()))


def test_flash_attention_bwd_tf32x3_same_bits_in_every_layout(cuda_device):
    """The same values as contiguous tensors, as column slices of wider
    tensors (16-byte aligned, read by cp.async, and 3 elements in, read
    element by element) and with heads outside positions give the tf32x3
    backward's same bits."""
    q, k, v, _, _, do = _flash_fwd_with_lse(cuda_device, 2, 70, 70, 4, 1, 64, True,
                                            torch.float32, seed=12)

    def sliced(x, off):
        wide = torch.zeros((*x.shape[:-1], 64 + off + 4), device=x.device)
        return wide[..., off:off + 64].copy_(x)

    def heads_outside(x):
        return x.transpose(1, 2).contiguous().transpose(1, 2)

    for causal in (True, False):
        o, lse = fa.flash_attention_lse(q, k, v, causal)
        want = fa.flash_attention_bwd(q, k, v, o, do, lse, causal)
        for layout in (lambda x: sliced(x, 4), lambda x: sliced(x, 3), heads_outside):
            views = [layout(x) for x in (q, k, v, o, do)]
            before = fa.launches_bwd_tf32x3
            got = fa.flash_attention_bwd(*views, lse, causal)
            assert fa.launches_bwd_tf32x3 == before + 1
            assert all(torch.equal(a, b_) for a, b_ in zip(got, want)), causal


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_tf32x3_holds_the_bound_on_same_sign_values(cuda_device,
                                                                        causal):
    """Scores of std ~4 and v and do shifted by 2 at FuXi's T and hd: MMA
    sums whose terms share a sign (dv's above all), which drift when one
    running sum takes them all (the tensor cores truncate), stay within
    ``ref.flash_attention_bwd_bound``."""
    q, k, v = _flash_case(cuda_device, 4, 512, 512, 8, 8, 64, torch.float32, seed=9)
    q, k, v = 2 * q, 2 * k, v + 2
    out, lse = fa.flash_attention_lse(q, k, v, causal)
    g = torch.Generator(cuda_device).manual_seed(10)
    do = torch.randn(out.shape, device=cuda_device, generator=g) + 2
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal)
    bounds = ref.flash_attention_bwd_bound(q, k, v, out, do, lse, want, causal)
    for name, g_, w, bd in zip(("dq", "dk", "dv"), got, want, bounds):
        assert bool(((g_ - w).abs() <= bd).all()), (name, float((g_ - w).abs().max()))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_wgmma_gqa_and_views_beside_the_general_kernel(cuda_device,
                                                                           causal):
    """The wgmma backward at hd 128 with 4 query heads a kv head (T 300:
    two 128-row tiles and a partial one) within the bf16 bound of the
    plain backward, one launch a call; the general kernel, forced on the
    same bf16 inputs, within the f32 bound; and views TMA cannot describe
    (3 elements off alignment, a row stride of 132 elements) copied for the
    kernel and given the contiguous inputs' bits."""
    q, k, v, o, lse, do = _flash_fwd_with_lse(cuda_device, 2, 300, 300, 8, 2, 128, causal,
                                              torch.bfloat16, seed=30)
    assert fa.bwd_variant(q, k, v) == "wgmma"
    before = (fa.launches_bwd_wgmma, fa.launches_bwd_simple)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal)
    general = fa.flash_attention_bwd_simple(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    assert (fa.launches_bwd_wgmma, fa.launches_bwd_simple) == (before[0] + 1, before[1] + 1)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    for products, grads in (("bf16", got), ("f32", general)):
        bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, causal,
                                               products=products)
        for name, g_, w, bd in zip(("dq", "dk", "dv"), grads, want, bounds):
            err = (g_.float() - w.float()).abs()
            assert bool((err <= bd).all()), (products, name, float(err.max()))

    def sliced(x, off, pad):
        wide = torch.zeros((*x.shape[:-1], 128 + off + pad), dtype=x.dtype, device=x.device)
        return wide[..., off:off + 128].copy_(x)

    for off, pad in ((3, 5), (0, 4)):
        views = [sliced(x, off, pad) for x in (q, k, v, o, do)]
        assert not any(fa.tma_ok(x) for x in views)
        before = fa.launches_bwd_wgmma
        again = fa.flash_attention_bwd(*views, lse, causal)
        assert fa.launches_bwd_wgmma == before + 1
        assert all(torch.equal(a, b_) for a, b_ in zip(again, got)), (off, pad)


@pytest.mark.parametrize("mul", [1, 2, 3])
def test_flash_attention_bwd_wgmma_holds_the_bound_on_same_sign_values(cuda_device, mul):
    """q and k of one sign (|N(0, 1)| times 1, 2, 3: scores of 5 to 50, alike
    from key to key) at stablelm-3b's head dim and T 512: long sums whose
    terms share a sign, and large scores, stay within the bf16 bound."""
    q, k, v = _flash_case(cuda_device, 1, 512, 512, 4, 4, 80, torch.float32, seed=40 + mul)
    q, k, v = (mul * q.abs()).to(torch.bfloat16), (mul * k.abs()).to(torch.bfloat16), \
        v.to(torch.bfloat16)
    out, lse = fa.flash_attention_lse(q, k, v, True)
    do = torch.randn(out.shape, device=cuda_device).to(torch.bfloat16)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, True)
    bounds = ref.flash_attention_bwd_bound(q, k, v, out, do, lse, want, True, products="bf16")
    for name, g_, w, bd in zip(("dq", "dk", "dv"), got, want, bounds):
        err = (g_.float() - w.float()).abs()
        assert bool((err <= bd).all()), (name, float(err.max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_equals_plain(cuda_device, dtype):
    """The forward's row logsumexp within ``ref.flash_attention_lse_bound``
    of the plain one, and its output the bits the same kernel gives without
    the lse (``fa.lse_variant`` is ``fa.variant``: the tf32x3 kernel for f32
    at hd <= 128, the wgmma kernel for bf16 at its head dims, else the
    general one)."""
    for b, tq, tk, h, kv, hd, causal in FLASH_BWD_CASES:
        q, k, v = _flash_case(cuda_device, b, tq, tk, h, kv, hd, dtype, seed=hd)
        out, lse = fa.flash_attention_lse(q, k, v, causal)
        assert lse.shape == (b, h, tq) and lse.dtype == torch.float32
        kind = fa.lse_variant(q, k, v)
        alone = fa.flash_attention if kind == fa.variant(q, k, v) else fa.flash_attention_simple
        assert torch.equal(out, alone(q, k, v, causal))
        want = ref.flash_attention_lse_ref(q, k, causal)
        assert bool(((lse - want).abs() <= ref.flash_attention_lse_bound(q, k, want,
                                                                         causal)).all())


def test_flash_attention_autograd_runs_the_kernels(cuda_device):
    """Small f32 inputs through ``dispatch.flash_attention`` under autograd:
    one tf32x3 forward and one tf32x3 backward launch (none of the general
    or the wgmma forward, nor of the general backward), the gradients the
    backward kernel gives, and within its bound of autograd of the plain
    version."""
    q, k, v = _flash_case(cuda_device, 2, 9, 9, 4, 2, 8, torch.float32, seed=3)
    do = torch.randn(q.shape, device=cuda_device)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fa.launches_tf32x3, fa.launches_simple, fa.launches_wgmma,
              fa.launches_bwd_tf32x3, fa.launches_bwd_simple)
    out = dispatch.flash_attention(*leaves, True)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.launches_tf32x3, fa.launches_simple, fa.launches_wgmma,
            fa.launches_bwd_tf32x3, fa.launches_bwd_simple) == \
        (before[0] + 1, before[1], before[2], before[3] + 1, before[4])
    o, lse = fa.flash_attention_lse(q, k, v, True)
    for leaf, w in zip(leaves, fa.flash_attention_bwd(q, k, v, o, do, lse, True)):
        assert torch.equal(leaf.grad, w)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    ref.flash_attention_ref(*plain, True).backward(do)
    bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse,
                                           [x.grad for x in plain], True)
    for leaf, p_, bd in zip(leaves, plain, bounds):
        assert bool(((leaf.grad - p_.grad).abs() <= bd).all())
    counts = (fa.launches_tf32x3, fa.launches_bwd)
    with torch.no_grad():  # no grad wanted: the forward kernel alone
        dispatch.flash_attention(*leaves, True)
    assert (fa.launches_tf32x3, fa.launches_bwd) == (counts[0] + 1, counts[1])


def test_flash_attention_wgmma_with_grad_raises(cuda_device):
    """bf16 at a wgmma head dim under autograd (it raised until the wgmma
    forward wrote its lse): one wgmma forward with its lse and one wgmma
    backward launch, none of the other forwards nor of the general
    backward, the output the wgmma kernel's bits, the gradients those of
    the backward kernel on that lse."""
    q, k, v = _flash_case(cuda_device, 1, 16, 16, 2, 1, 64, torch.bfloat16, seed=4)
    assert fa.variant(q, k, v) == fa.bwd_variant(q, k, v) == "wgmma"
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fa.launches_wgmma, fa.launches, fa.launches_bwd_wgmma, fa.launches_bwd_simple,
              fa.launches_bwd)
    out = dispatch.flash_attention(*leaves, True)
    do = torch.ones_like(out)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.launches_wgmma, fa.launches, fa.launches_bwd_wgmma, fa.launches_bwd_simple,
            fa.launches_bwd) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3], before[4] + 1)
    assert torch.equal(out, fa.flash_attention(q, k, v, True))
    o, lse = fa.flash_attention_lse(q, k, v, True)
    for leaf, w in zip(leaves, fa.flash_attention_bwd(q, k, v, o, do, lse, True)):
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize("hd", fa.WGMMA_HEAD_DIMS)
def test_flash_attention_wgmma_lse_equals_plain(cuda_device, hd):
    """The wgmma forward's row logsumexp within ``ref.flash_attention_lse_bound``
    of ``ref.flash_attention_lse_ref`` at every wgmma head dim, causal and
    not, T of one row, of a partial tile and of several tiles, and on a
    strided view (column slices of one wider tensor, read in place); one
    wgmma launch a call, and the output bit for bit what the kernel gives
    without the lse."""
    cases = [(1, 1, 1, 2, 2), (2, 100, 100, 4, 1), (1, 257, 257, 2, 2), (1, 33, 140, 4, 2)]
    for b, tq, tk, h, kv in cases:
        for causal in (True, False):
            q, k, v = _flash_case(cuda_device, b, tq, tk, h, kv, hd, torch.bfloat16,
                                  seed=tq + hd)
            views = [(q, k, v)]
            if tq == 100:
                wide = torch.randn((b, tq, h, 3 * hd + 8), device=cuda_device).to(
                    torch.bfloat16)
                views.append((wide[..., 8:8 + hd], wide[..., 8 + hd:8 + 2 * hd],
                              wide[..., 8 + 2 * hd:]))
            for q_, k_, v_ in views:
                assert fa.lse_variant(q_, k_, v_) == "wgmma"
                before = (fa.launches_wgmma, fa.launches)
                out, lse = fa.flash_attention_lse(q_, k_, v_, causal)
                assert (fa.launches_wgmma, fa.launches) == (before[0] + 1, before[1] + 1)
                assert lse.shape == (b, h, tq) and lse.dtype == torch.float32
                assert torch.equal(out, fa.flash_attention(q_, k_, v_, causal))
                want = ref.flash_attention_lse_ref(q_, k_, causal)
                bound = ref.flash_attention_lse_bound(q_, k_, want, causal)
                assert bool(((lse - want).abs() <= bound).all()), (tq, causal)


def test_variants_at_wgmma_head_dims(cuda_device):
    """bf16 at every wgmma head dim: the wgmma forward, with and without
    the lse, and the wgmma backward at hd 64, 80, 128 and 160, the general
    one at 192 and 256; f32 at hd 80 and 160: tf32x3 and the general
    kernel, forward and backward."""
    for hd in fa.WGMMA_HEAD_DIMS:
        q, k, v = _flash_case(cuda_device, 1, 4, 4, 2, 1, hd, torch.bfloat16, seed=hd)
        assert (fa.variant(q, k, v), fa.lse_variant(q, k, v), fa.bwd_variant(q, k, v)) == \
            ("wgmma", "wgmma", "wgmma" if hd in (64, 80, 128, 160) else "simple")
    for hd, kind in ((80, "tf32x3"), (160, "simple")):
        q, k, v = _flash_case(cuda_device, 1, 4, 4, 2, 1, hd, torch.float32, seed=hd)
        assert (fa.variant(q, k, v), fa.lse_variant(q, k, v), fa.bwd_variant(q, k, v)) == \
            (kind, kind, kind)


@pytest.mark.parametrize("hd", [80, 160])
def test_flash_attention_bf16_grads_at_wgmma_dims_equal_plain(cuda_device, hd):
    """``dispatch.flash_attention`` under autograd, bf16 at hd 80 (stablelm-3b)
    and 160 (stablelm-12b, pixtral-12b), causal, GQA: gradients within the
    bf16 form of ``ref.flash_attention_bwd_bound`` of the plain backward on
    the wgmma forward's output and lse, one wgmma forward and one wgmma
    backward launch at both, none of the other attention kernels."""
    q, k, v = _flash_case(cuda_device, 2, 200, 200, 4, 2, hd, torch.bfloat16, seed=hd)
    do = torch.randn(q.shape, device=cuda_device).to(torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fa.launches_wgmma, fa.launches_bwd_wgmma, fa.launches_bwd_simple,
              fa.launches_bwd_tf32x3, fa.launches_simple, fa.launches_tf32x3)
    dispatch.flash_attention(*leaves, True).backward(do)
    torch.cuda.synchronize()
    assert (fa.launches_wgmma, fa.launches_bwd_wgmma, fa.launches_bwd_simple,
            fa.launches_bwd_tf32x3, fa.launches_simple, fa.launches_tf32x3) == (
        before[0] + 1, before[1] + 1, before[2], before[3], before[4], before[5])
    o, lse = fa.flash_attention_lse(q, k, v, True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, True, products="bf16")
    for name, leaf, w, bd in zip("qkv", leaves, want, bounds):
        err = (leaf.grad.float() - w.float()).abs()
        assert bool((err <= bd).all()), (name, float(err.max()))


def test_fuxi_training_on_the_card_runs_the_kernels_and_matches_cpu(cuda_device):
    """``fuxi-reduced`` (2 layers, N = 4): 2 x 2 x 4 tf32x3 forward and
    2 x 4 tf32x3 backward launches a step (each layer's forward runs again
    in the backward), no launch of the general or the wgmma forward nor of
    the general backward, and the CPU's trajectory within 1e-5 at the
    configuration's own step sizes."""
    kw = dict(reduced=True, global_batch=16, n_micro=4, seed=3)
    gpu = Session.from_arch("fuxi-kuairand", **kw)
    cpu = Session.from_arch("fuxi-kuairand", device="cpu", **kw)
    cpu.state = clone_state(gpu.state, "cpu")
    before = (fa.launches_tf32x3, fa.launches_simple, fa.launches_wgmma,
              fa.launches_bwd_tf32x3, fa.launches_bwd_simple)
    steps = 4
    got, want = gpu.train(steps), cpu.train(steps)
    assert (fa.launches_tf32x3 - before[0], fa.launches_simple - before[1],
            fa.launches_wgmma - before[2], fa.launches_bwd_tf32x3 - before[3],
            fa.launches_bwd_simple - before[4]) == (16 * steps, 0, 0, 8 * steps, 0)
    assert got.summary["overflow_max"] == 0
    np.testing.assert_allclose(got.stats.losses, want.stats.losses, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.state.table.rows.cpu(), want.state.table.rows,
                               rtol=0, atol=1e-5)
    for k, v in want.state.dense.items():
        torch.testing.assert_close(got.state.dense[k].cpu(), v, rtol=0, atol=1e-5)


def _lm_bf16_hd80():
    """A small stablelm-3b at its own head dim and types: 2 layers of 2
    heads of 80 (d_model 160), bf16 params and compute, the reduced
    vocabulary: its attention goes through the wgmma forward and the
    general bf16 backward."""
    red = get_arch("stablelm-3b").reduced
    cfg = dataclasses.replace(red, name="stablelm-3b-bf16-hd80", d_model=160, d_ff=432,
                              param_dtype="bfloat16", compute_dtype="bfloat16",
                              attention=dataclasses.replace(red.attention, n_heads=2,
                                                            n_kv_heads=2, head_dim=80))
    return ArchSpec(cfg.name, "lm", cfg, cfg), cfg


def test_lm_training_on_the_card_runs_the_kernels_and_matches_cpu(cuda_device):
    """Reduced stablelm-3b (f32, hd 16: the tf32x3 forward and backward,
    2 x 2 x 2 and 2 x 2 launches a step) against the port on the CPU
    within 1e-5 (AdamW eps 1e-6, as the CPU parity tests against JAX);
    then the bf16 config at hd 80 (the wgmma forward with its lse and the
    wgmma backward, at the same counts, none of the tf32x3 kernels nor of
    the general ones), its losses within 3% of the CPU's (both round to
    bf16 at every op, in other orders)."""
    steps = 3
    kw = dict(global_batch=8, seq_len=16, n_micro=2, t_chunk=8, seed=3,
              opt_cfg=OptimizerConfig(lr=2e-3, eps=1e-6))
    gpu = Session.from_arch("stablelm-3b", reduced=True, **kw)
    cpu = Session.from_arch("stablelm-3b", reduced=True, device="cpu", **kw)
    cpu.state = clone_state(gpu.state, "cpu")
    before = (fa.launches_tf32x3, fa.launches_bwd_tf32x3, fa.launches_wgmma,
              fa.launches_bwd_simple, fa.launches_simple)
    got, want = gpu.train(steps), cpu.train(steps)
    assert (fa.launches_tf32x3 - before[0], fa.launches_bwd_tf32x3 - before[1],
            fa.launches_wgmma - before[2], fa.launches_bwd_simple - before[3],
            fa.launches_simple - before[4]) == (8 * steps, 4 * steps, 0, 0, 0)
    assert got.summary["overflow_max"] == 0
    np.testing.assert_allclose(got.stats.losses, want.stats.losses, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.state.table.rows.cpu(), want.state.table.rows,
                               rtol=0, atol=1e-5)
    for k, v in want.state.dense.items():
        torch.testing.assert_close(got.state.dense[k].cpu(), v, rtol=0, atol=1e-5)

    arch, cfg = _lm_bf16_hd80()
    wkw = dict(global_batch=4, seq_len=200, t_chunk=64)
    gpu = Session.from_workload(assemble_workload(arch, cfg, device=cuda_device, **wkw),
                                seed=3)
    cpu = Session.from_workload(assemble_workload(arch, cfg, device="cpu", **wkw), seed=3)
    cpu.state = clone_state(gpu.state, "cpu")
    before = (fa.launches_wgmma, fa.launches_bwd_wgmma, fa.launches_tf32x3,
              fa.launches_bwd_tf32x3, fa.launches_simple, fa.launches_bwd_simple)
    got, want = gpu.train(steps), cpu.train(steps)
    assert (fa.launches_wgmma - before[0], fa.launches_bwd_wgmma - before[1],
            fa.launches_tf32x3 - before[2], fa.launches_bwd_tf32x3 - before[3],
            fa.launches_simple - before[4], fa.launches_bwd_simple - before[5]) == (
        16 * steps, 8 * steps, 0, 0, 0, 0)
    assert np.isfinite(got.stats.losses).all()
    np.testing.assert_allclose(got.stats.losses, want.stats.losses, rtol=0.03, atol=0)


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


def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path, monkeypatch):
    """A device-tier state saved from the card through many small chunks:
    each leaf file holds np.save's bytes of the tensor; a session from
    another seed restores it in place (the same tensors, still on the
    card) with the same bits, and both train on alike."""
    import io
    import json

    from repro_torch.dist import checkpoint as ck

    monkeypatch.setattr(ck, "CHUNK_BYTES", 4096)
    kw = dict(reduced=True, global_batch=32, n_micro=4, ckpt_dir=str(tmp_path))
    a = Session.from_arch("dlrm-ctr", seed=0, **kw)
    a.train(2)
    path = a.save()
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    leaves = ck.flatten_state(a.state)
    for e, (name, t) in zip(manifest["leaves"], leaves):
        assert t.device.type == "cuda", name
        buf = io.BytesIO()
        np.save(buf, t.cpu().numpy())
        assert open(os.path.join(path, e["file"]), "rb").read() == buf.getvalue(), name
    b = Session.from_arch("dlrm-ctr", seed=1, data_seed=0, **kw)
    ptrs = [t.data_ptr() for _, t in ck.flatten_state(b.state)]
    assert b.restore_if_available() == 2
    got = ck.flatten_state(b.state)
    assert [t.data_ptr() for _, t in got] == ptrs  # in place
    for (name, x), (_, y) in zip(got, leaves):
        assert x.device.type == "cuda" and torch.equal(x, y), name
    assert b.train(2).stats.losses == a.train(2).stats.losses
    assert torch.equal(b.state.table.rows, a.state.table.rows)


def test_save_time_stays_out_of_the_step_spans_on_the_card(cuda_device):
    """A step's span on the card runs from the previous step's event: after
    a slow save the driver records a fresh mark, so the save's seconds land
    in no step and flag no straggler."""
    import time

    sess = Session.from_arch("dlrm-ctr", reduced=True, global_batch=32, n_micro=4)
    pause = 0.5
    driver = sess.strategy.build_driver(
        sess.fns, resolve_stream(sess.workload, sess.data_seed), sess.workload,
        on_checkpoint=lambda state, n: time.sleep(pause), ckpt_every=2,
        metrics_every=1)
    _, stats = driver.run(sess._take_state(), 5)
    assert stats.straggler_steps == []
    assert max(stats.step_times[1:]) < pause / 2, stats.step_times


# every host-store site once (step=N counts the calls to its own site); 6
# steps reach the sixth d2h pull
CHAOS = "plan:step=1;retrieve:step=2;commit:step=3;h2d:step=1;d2h:step=5"


@pytest.mark.parametrize("tier", ["host", "cached"])
@pytest.mark.parametrize("async_on", ["off", "on"])
def test_chaos_recovers_bit_for_bit_on_the_card(cuda_device, tier, async_on):
    """A fault at every store site on the card: each fires before its
    stage's first CUDA work, so the bounded retries replay host work only
    and the run keeps the fault-free run's bits."""
    kw = dict(reduced=True, global_batch=32, n_micro=4, store=tier,
              async_stages=async_on)
    want = Session.from_arch("dlrm-ctr", fault_inject="off", **kw).train(6)
    got = Session.from_arch("dlrm-ctr", fault_inject=CHAOS, **kw).train(6)
    assert got.stats.losses == want.stats.losses
    assert torch.equal(got.state.table.rows, want.state.table.rows)
    assert torch.equal(got.state.table.accum, want.state.table.accum)
    s = got.summary
    assert s["faults_injected"] == 5
    assert s["stage_retries"] >= 3 and s["commit_rollbacks"] >= 2


def test_preemption_resume_on_the_card(cuda_device, tmp_path, monkeypatch):
    """A real signal mid-run (SIGUSR1 on the session's guard, sent when the
    batch source yields its third batch; the handler runs on the main
    thread): the async host-tier run stops at a step boundary, saves on its
    way out, and a session from another seed resumes to the uninterrupted
    run's bits. The guard gives the signal back afterwards."""
    import signal

    from repro_torch.api import session as session_mod
    from repro_torch.dist import checkpoint as ck

    steps = 6
    kw = dict(reduced=True, global_batch=32, n_micro=4, store="host",
              async_stages="on", data_seed=0)
    ref = Session.from_arch("dlrm-ctr", seed=0, **kw)
    ref_losses = ref.train(steps).stats.losses
    real = session_mod.resolve_stream

    def signalling_stream(*a, **skw):
        def batches():
            for i, batch in enumerate(real(*a, **skw)):
                if i == 2:
                    os.kill(os.getpid(), signal.SIGUSR1)
                yield batch
        return batches()

    before = signal.getsignal(signal.SIGUSR1)
    a = Session.from_arch("dlrm-ctr", seed=0, ckpt_dir=str(tmp_path),
                          preemption_signals=(signal.SIGUSR1,), **kw)
    try:
        monkeypatch.setattr(session_mod, "resolve_stream", signalling_stream)
        rep = a.train(steps)
    finally:
        a.guard.restore()
    assert signal.getsignal(signal.SIGUSR1) is before
    at = rep.stats.preempted_at
    assert at is not None and 1 <= at < steps and len(rep.stats.losses) == at
    monkeypatch.setattr(session_mod, "resolve_stream", real)
    b = Session.from_arch("dlrm-ctr", seed=1, ckpt_dir=str(tmp_path), **kw)
    assert b.restore_if_available() == at
    assert rep.stats.losses + b.train(steps - at).stats.losses == ref_losses
    for (name, x), (_, y) in zip(ck.flatten_state(b.state), ck.flatten_state(ref.state)):
        assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_inputs(device, dtype, seed=0):
    from repro_torch.models import layers as L

    cfg = get_arch("olmoe-1b-7b").reduced
    g = torch.Generator().manual_seed(seed)
    params = L.init_moe(cfg.d_model, cfg.d_ff, cfg.moe, cfg.mlp_type, dtype=dtype,
                        generator=g)
    x = torch.randn((4, 64, cfg.d_model), generator=g).to(dtype)
    c = torch.randn(x.shape, generator=g).to(dtype)
    return cfg, {k: v.to(device) for k, v in params.items()}, x.to(device), c.to(device)


def _moe_fwd_bwd(cfg, params, x, c):
    from repro_torch.models import layers as L

    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    xx = x.detach().requires_grad_()
    out, aux = L.apply_moe(leaves, xx, cfg.moe, cfg.mlp_type, cfg.activation)
    grads = torch.autograd.grad((out.float() * c.float()).sum() + aux, [xx, *leaves.values()])
    return [out.detach(), aux.detach(), *grads]


def test_moe_layer_on_the_card_matches_the_cpu_and_repeats_its_bits(cuda_device):
    """The slotted MoE of the reduced olmoe (8 experts top-2, 256 tokens),
    f32: output, aux and every gradient within 1e-5 of the CPU's, and the
    same bits on a second run on the card (its dispatch and combine are
    gathers both ways: no atomics)."""
    cfg, params, x, c = _moe_inputs("cpu", torch.float32)
    want = _moe_fwd_bwd(cfg, params, x, c)
    on_card = [t.to(cuda_device) for t in (x, c)]
    p_card = {k: v.to(cuda_device) for k, v in params.items()}
    got = _moe_fwd_bwd(cfg, p_card, *on_card)
    again = _moe_fwd_bwd(cfg, p_card, *on_card)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert float((a.cpu() - w).abs().max()) <= 1e-5


def test_bf16_moe_checkpoint_resumes_on_the_card(cuda_device, tmp_path):
    """A 2-layer bf16 olmoe at hd 128 (the wgmma forward and backward)
    trains 2 steps, saves (bf16 leaves), trains 2 more; a session from
    another seed restores it and trains 2: the same losses and every leaf,
    bit for bit."""
    from repro_torch.dist.checkpoint import flatten_state

    red = get_arch("olmoe-1b-7b").reduced
    cfg = dataclasses.replace(red, name="olmoe-bf16-hd128", d_model=256, d_ff=128,
                              param_dtype="bfloat16", compute_dtype="bfloat16",
                              attention=dataclasses.replace(red.attention, n_heads=2,
                                                            n_kv_heads=2, head_dim=128))

    def session(seed):
        wl = assemble_workload(ArchSpec(cfg.name, "lm", cfg, cfg), cfg, device=cuda_device,
                               global_batch=8, seq_len=128, t_chunk=64)
        return Session.from_workload(wl, seed=seed, data_seed=0, ckpt_dir=str(tmp_path))

    a = session(0)
    a.train(2)
    a.save()
    rep_a = a.train(2)
    b = session(1)
    assert b.restore_if_available() == 2
    assert b.state.dense["blocks.0.moe.wi"].dtype == torch.bfloat16
    rep_b = b.train(2)
    assert rep_b.stats.losses == rep_a.stats.losses
    for (pa, ta), (pb, tb) in zip(flatten_state(a.state), flatten_state(b.state)):
        assert pa == pb and torch.equal(ta, tb), pa


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def _mamba_cfg(**mamba):
    red = get_arch("mamba2-370m").reduced
    return dataclasses.replace(red, mamba=dataclasses.replace(red.mamba, **mamba))


def test_mamba_ssd_chunked_equals_the_f64_recurrence_on_the_card(cuda_device):
    """The chunked SSD (f32, TF32 off) at chunk 64 over L 300 (a padded last
    chunk), 8 heads of 16 in 2 groups, N 32, from an entering state: y and
    the final state within 1e-4 of their largest magnitude of the port's
    O(L) recurrence in f64 on the card."""
    from repro_torch.models import mamba as M

    g = torch.Generator().manual_seed(0)
    b, length, h, p, n = 2, 300, 8, 16, 32
    x = torch.randn((b, length, h, p), generator=g)
    dt = torch.rand((b, length, h), generator=g) * 0.1
    A = -torch.arange(1, h + 1, dtype=torch.float32) * 4
    Bm, Cm = (torch.randn((b, length, 2, n), generator=g) for _ in range(2))
    s0 = torch.randn((b, h, p, n), generator=g)
    args = [t.to(cuda_device) for t in (x, dt, A, Bm, Cm)]
    assert not torch.backends.cuda.matmul.allow_tf32
    y, s = M.ssd_chunked(*args, 64, s0.to(cuda_device))
    ry, rs = M.ssd_reference(*args, s0.to(cuda_device), dtype=torch.float64)
    assert y.is_cuda and y.dtype == torch.float32
    assert float((y.double() - ry).abs().max()) <= 1e-4 * float(ry.abs().max())
    assert float((s.double() - rs).abs().max()) <= 1e-4 * float(rs.abs().max())


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_mamba_prefill_plus_decode_equals_the_longer_prefill_on_the_card(cuda_device, arch):
    """Reduced, f32: a prefill of T tokens and one decode step against a
    prefill of T + 1 (the conv and ssm states carried), last-token logits
    within 1e-4; the prefill within 1e-5 of the CPU's."""
    from repro_torch.models import transformer as TT

    cfg = get_arch(arch).reduced
    g = torch.Generator().manual_seed(1)
    params = TT.init_lm_params(cfg, device="cpu", generator=g)
    emb = torch.randn((2, 21, cfg.d_model), generator=g) * 0.5
    p_card = {k: v.to(cuda_device) for k, v in params.items()}
    e_card = emb.to(cuda_device)
    with torch.inference_mode():
        short, cache = TT.lm_prefill(p_card, cfg, e_card[:, :20], cache_len=21)
        step, _ = TT.lm_decode_step(p_card, cfg, e_card[:, 20:], cache)
        whole, _ = TT.lm_prefill(p_card, cfg, e_card)
        cpu, _ = TT.lm_prefill(params, cfg, emb[:, :20], cache_len=21)
    assert float((step - whole).abs().max()) <= 1e-4
    assert float((short.cpu() - cpu).abs().max()) <= 1e-5


def test_mamba_step_at_chunk_256_has_a_finite_gradient_on_the_card(cuda_device):
    """mamba2-370m-reduced at the published chunk of 256 over 256 tokens
    (16 heads: A down to -16, dt up to 0.1, so exp(a_i - a_j) overflows
    above the diagonal): two nestpipe steps on the card give finite losses
    and leave every weight finite (the masked decay's gradient)."""
    cfg = _mamba_cfg(chunk_size=256)
    wl = assemble_workload(ArchSpec(cfg.name, "lm", cfg, cfg), cfg, device=cuda_device,
                           global_batch=4, seq_len=256, t_chunk=64)
    sess = Session.from_workload(wl, seed=0)
    rep = sess.train(2)
    assert np.isfinite(rep.stats.losses).all()
    assert all(bool(torch.isfinite(v).all()) for v in rep.state.dense.values())
    assert int(rep.state.step) == 2


@pytest.mark.parametrize("tq,tk", [(100, 300), (300, 100)])
def test_flash_attention_wgmma_hd64_non_causal_ragged_forward_and_backward(cuda_device,
                                                                         tq, tk):
    """The encoder-decoder's attention at a small size: bf16 at hd 64 without
    a mask, Tq != Tk, neither a multiple of 128 (the cross attention's 448
    queries against 1,500 keys, and the reverse). The wgmma forward (with
    and without its lse) within ``ref.flash_attention_bound`` of the plain
    version and its lse within ``ref.flash_attention_lse_bound``; the wgmma
    backward within the bf16 form of ``ref.flash_attention_bwd_bound``
    (its last key tile partly out of range when Tk is 300); one launch a
    call of each, and the same bits twice."""
    q, k, v = _flash_case(cuda_device, 2, tq, tk, 8, 8, 64, torch.bfloat16, seed=tq + 7)
    assert fa.variant(q, k, v) == fa.lse_variant(q, k, v) == fa.bwd_variant(q, k, v) == "wgmma"
    before = (fa.launches_wgmma, fa.launches_bwd_wgmma, fa.launches_simple,
              fa.launches_bwd_simple)
    out = fa.flash_attention(q, k, v, False)
    out_lse, lse = fa.flash_attention_lse(q, k, v, False)
    again, lse_again = fa.flash_attention_lse(q, k, v, False)
    do = torch.randn(out.shape, device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(tk)).to(torch.bfloat16)
    got = fa.flash_attention_bwd(q, k, v, out_lse, do, lse, False)
    got_again = fa.flash_attention_bwd(q, k, v, out_lse, do, lse, False)
    torch.cuda.synchronize()
    assert (fa.launches_wgmma, fa.launches_bwd_wgmma, fa.launches_simple,
            fa.launches_bwd_simple) == (before[0] + 3, before[1] + 2, before[2], before[3])
    assert torch.equal(out, out_lse) and torch.equal(out_lse, again)
    assert torch.equal(lse, lse_again)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, got_again))
    want = ref.flash_attention_ref(q, k, v, False)
    err = (out.float() - want.float()).abs()
    assert bool((err <= ref.flash_attention_bound(q, k, v, want, False)).all())
    lse_want = ref.flash_attention_lse_ref(q, k, False)
    assert bool(((lse - lse_want).abs()
                 <= ref.flash_attention_lse_bound(q, k, lse_want, False)).all())
    gwant = ref.flash_attention_bwd_ref(q, k, v, out_lse, do, lse, False)
    bounds = ref.flash_attention_bwd_bound(q, k, v, out_lse, do, lse, gwant, False,
                                           products="bf16")
    for name, g_, w, bd in zip(("dq", "dk", "dv"), got, gwant, bounds):
        assert g_.shape == w.shape and g_.dtype == torch.bfloat16, name
        err = (g_.float() - w.float()).abs()
        assert bool((err <= bd).all()), (name, float(err.max()))


def test_encdec_prefill_plus_decode_equals_the_longer_prefill_on_the_card(cuda_device):
    """A small bf16 encoder-decoder at whisper's head dim (2 + 2 layers,
    d_model 128, 2 heads of 64, 100 frames): its prefill runs every
    attention through the wgmma forward (2 encoder, 2 decoder self and 2
    cross calls), and a prefill of 20 tokens and one decode step are
    within 5e-2 of max |logit| of a prefill of 21 (the self and the memory
    caches carried; both round to bf16 at every op, the decode step in
    plain PyTorch: ~1e-2 on the CPU); the prefill within 5e-2 of the
    CPU's."""
    from repro_torch.models import encdec as TE

    red = get_arch("whisper-base").reduced
    cfg = dataclasses.replace(
        red, d_model=128, d_ff=256, compute_dtype="bfloat16",
        attention=dataclasses.replace(red.attention, n_heads=2, n_kv_heads=2, head_dim=64),
        encoder=dataclasses.replace(red.encoder, n_frames=100))
    g = torch.Generator().manual_seed(2)
    params = TE.init_encdec_params(cfg, device="cpu", generator=g)
    emb = torch.randn((2, 21, cfg.d_model), generator=g) * 0.5
    frames = torch.randn((2, 100, cfg.d_model), generator=g) * 0.5
    p_card = {k: v.to(cuda_device) for k, v in params.items()}
    e_card, f_card = emb.to(cuda_device), frames.to(cuda_device)
    with torch.inference_mode():
        before = fa.launches_wgmma
        short, cache = TE.encdec_prefill(p_card, cfg, e_card[:, :20], f_card, cache_len=21)
        torch.cuda.synchronize()
        assert fa.launches_wgmma == before + 6
        assert cache.mem_k.shape == (2, 2, 100, 2, 64) and cache.mem_k.dtype == torch.bfloat16
        step, cache = TE.encdec_decode_step(p_card, cfg, e_card[:, 20:], cache)
        whole, _ = TE.encdec_prefill(p_card, cfg, e_card, f_card)
        cpu, _ = TE.encdec_prefill(params, cfg, emb[:, :20], frames, cache_len=21)
    scale = float(whole.abs().max())
    assert torch.isfinite(step).all() and cache.length == 21
    assert float((step - whole).abs().max()) <= 5e-2 * scale
    assert float((short.cpu() - cpu).abs().max()) <= 5e-2 * float(cpu.abs().max())


def _vlm_bf16_hd160():
    """A narrow pixtral-12b at its own head dim and types: 2 layers of 2
    heads of 160 over 1 kv head (d_model 320), bf16 params and compute, 8
    patches, the reduced vocabulary: its attention goes through the wgmma
    forward (with its lse when training) and the general bf16 backward."""
    red = get_arch("pixtral-12b").reduced
    cfg = dataclasses.replace(red, name="pixtral-12b-bf16-hd160", d_model=320, d_ff=512,
                              param_dtype="bfloat16", compute_dtype="bfloat16",
                              attention=dataclasses.replace(red.attention, n_heads=2,
                                                            n_kv_heads=1, head_dim=160))
    return ArchSpec(cfg.name, "lm", cfg, cfg), cfg


def test_vlm_hd160_serving_and_training_on_the_card_match_cpu(cuda_device):
    """The narrow bf16 VLM at hd 160. Served (batch 2, 8 patches and a
    prompt of 40, 5 generated): one wgmma forward a layer (the prefill over
    the patches and the prompt), three gathers a lookup, vocabulary ids;
    its prefill logits within 5e-2 of max |logit| of the CPU's on the same
    weights, patches and prompt. Trained (4 x (8 patches + 192 text), N =
    4, 3 steps): 2 x 4 x 2 wgmma forwards with the lse and 2 x 4 wgmma
    backwards a step (none of the general or tf32x3 backward), finite losses
    within 3% of the CPU's (both round to bf16 at every op, in other
    orders)."""
    arch, cfg = _vlm_bf16_hd160()
    kw = dict(global_batch=4, seq_len=200, t_chunk=64)
    gpu = Session.from_workload(assemble_workload(arch, cfg, device=cuda_device, **kw), seed=3)
    cpu = Session.from_workload(assemble_workload(arch, cfg, device="cpu", **kw), seed=3)
    params, table = gpu.lm_weights()
    cpu.ingest({k: v.cpu() for k, v in params.items()},
               type(table)(table.rows.cpu(), table.accum.cpu()))
    before = (fa.launches_wgmma, eg.launches)
    rep = gpu.serve(batch=2, prompt_len=40, gen=5)
    torch.cuda.synchronize()
    assert (fa.launches_wgmma - before[0], eg.launches - before[1]) == (2, 3 * 5)
    assert rep.tokens.shape == (2, 5) and ((0 <= rep.tokens) & (rep.tokens < 512)).all()
    g = torch.Generator().manual_seed(4)
    patches = torch.randn((2, 8, 320), generator=g) * 0.02
    keys = torch.randint(0, 512, (2, 40), generator=g, dtype=torch.int32)
    logits = []
    for sess in (gpu, cpu):
        wl, (p_, t_) = sess.workload, sess.lm_weights()
        with torch.inference_mode():
            emb, _ = wl.engine.lookup_from_master(t_, keys.to(sess.device))
            full = torch.cat([patches.to(sess.device, emb.dtype), emb], dim=1)
            logits.append(wl.bundle.prefill(p_, full, cache_len=50)[0].cpu())
    assert torch.isfinite(logits[0]).all()
    assert float((logits[0] - logits[1]).abs().max()) <= 5e-2 * float(logits[1].abs().max())

    steps = 3
    cpu.state = clone_state(gpu.state, "cpu")
    before = (fa.launches_wgmma, fa.launches_bwd_simple, fa.launches_bwd_wgmma,
              fa.launches_tf32x3, fa.launches_bwd_tf32x3, fa.launches_simple)
    got, want = gpu.train(steps), cpu.train(steps)
    assert (fa.launches_wgmma - before[0], fa.launches_bwd_simple - before[1],
            fa.launches_bwd_wgmma - before[2], fa.launches_tf32x3 - before[3],
            fa.launches_bwd_tf32x3 - before[4], fa.launches_simple - before[5]) == (
        16 * steps, 0, 8 * steps, 0, 0, 0)
    assert np.isfinite(got.stats.losses).all()
    np.testing.assert_allclose(got.stats.losses, want.stats.losses, rtol=0.03, atol=0)
