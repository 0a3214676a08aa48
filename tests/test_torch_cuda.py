"""The port on the card: the hand-written CUDA kernel and the serving path.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one (the kernel has no CPU mode). The file imports no jax, so it
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
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import embedding_gather as eg

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
