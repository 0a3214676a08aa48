"""Embedding row gather on the card: the wrapper of ``csrc/embedding_gather.cu``.

Replaces the Pallas TPU kernel ``embedding_gather``
(``src/repro/kernels/embedding_gather.py``) and the clamp-then-mask around
it in ``repro.kernels.dispatch.gather_rows``: ``out[i] = table[idx[i]]``,
and a zero row where ``idx[i]`` is negative or ``>= len(table)``, in one
pass. The kernel is bound by memory bandwidth (``2 * n * D * 4 + 4 * n``
bytes, no arithmetic); its source note says how the design meets that.

The CUDA library builds at first use (``kernels/build.py``); nothing here
touches CUDA at import.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# Launches of the kernel in this process. Incremented only where the
# kernel launches, so a run can show that its path went through it.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        _fn = build.function("embedding_gather", "repro_embedding_gather_f32",
                             [p, i64, i64, p, i64, p, p])
    return _fn


def embedding_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(n, D)`` rows of a contiguous f32 ``(R, D)`` CUDA table at int32
    ``idx``; out-of-range indices give zero rows."""
    global launches
    if not (table.is_cuda and idx.device == table.device):
        raise ValueError(f"embedding_gather needs table and idx on one CUDA "
                         f"device, got {table.device} and {idx.device}")
    if table.dtype != torch.float32:
        raise TypeError(f"embedding_gather takes float32 tables, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"embedding_gather takes int32 indices, got {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"embedding_gather takes a (R, D) table and (n,) "
                         f"indices, got {tuple(table.shape)} and {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("embedding_gather takes contiguous tensors")
    rows, dim = table.shape
    n = idx.shape[0]
    out = torch.empty((n, dim), dtype=table.dtype, device=table.device)
    if n == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), rows, dim, idx.data_ptr(), n,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"embedding_gather launch failed: CUDA error {err}")
    launches += 1
    return out
