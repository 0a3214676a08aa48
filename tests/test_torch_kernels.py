"""The port's embedding gather against the JAX package's.

- the plain PyTorch gather (what a CPU tensor runs) equals JAX
  ``dispatch.gather_rows`` under both the reference and the interpret
  backends, bit for bit, on the sweep of tests/test_dispatch.py with 30%
  sentinel slots;
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
from repro_torch.kernels import embedding_gather as eg


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
    before = eg.launches
    table, idx = _case(50, 33, 64, seed=1)
    for _ in range(3):
        dispatch.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert eg.launches == before


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
