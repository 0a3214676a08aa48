"""Sparse-gradient segment sum on the card: the wrapper of ``csrc/segment_rowsum.cu``.

Replaces the Pallas TPU kernel ``segment_rowsum_sorted``
(``src/repro/kernels/segment_rowsum.py``): ``out[s]`` is the f32 sum of
the ``grads`` rows whose id is ``s``, for ``s`` in ``[0, S)``; ids outside
that range are dropped. Ids need not be sorted. The result is
deterministic: the positions are ordered by a stable integer sort
(``torch.sort(stable=True)``, preparation that the TPU kernel's body does
not need and whose time counts in this op's), a first kernel finds each
segment's run, then one warp per segment sums its rows in ascending input
position, without atomics. The op is
bound by memory bandwidth (each in-range row read once, each output row
written once); the source note says how the design meets that.

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
        _fn = build.function("segment_rowsum", "repro_segment_rowsum_f32",
                             [p, i64, p, p, i64, i64, p, p, p])
    return _fn


def segment_rowsum(grads: torch.Tensor, ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """``(num_segments, D)`` f32 sums of the contiguous f32 ``(L, D)`` CUDA
    ``grads`` rows by int32 segment ``ids`` ``(L,)``; ids outside
    ``[0, num_segments)`` are dropped."""
    global launches
    if not (grads.is_cuda and ids.device == grads.device):
        raise ValueError(f"segment_rowsum needs grads and ids on one CUDA "
                         f"device, got {grads.device} and {ids.device}")
    if grads.dtype != torch.float32:
        raise TypeError(f"segment_rowsum takes float32 grads, got {grads.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"segment_rowsum takes int32 ids, got {ids.dtype}")
    if grads.dim() != 2 or ids.dim() != 1 or ids.shape[0] != grads.shape[0]:
        raise ValueError(f"segment_rowsum takes (L, D) grads and (L,) ids, got "
                         f"{tuple(grads.shape)} and {tuple(ids.shape)}")
    if not (grads.is_contiguous() and ids.is_contiguous()):
        raise ValueError("segment_rowsum takes contiguous tensors")
    if num_segments < 0:
        raise ValueError(f"segment_rowsum: num_segments={num_segments} < 0")
    n, dim = grads.shape
    if n == 0 or num_segments == 0:
        return torch.zeros((num_segments, dim), dtype=torch.float32,
                           device=grads.device)
    out = torch.empty((num_segments, dim), dtype=torch.float32,
                      device=grads.device)
    starts = torch.empty((num_segments + 1,), dtype=torch.int64,
                         device=grads.device)  # scratch: each segment's run
    fn = _kernel()
    with torch.cuda.device(grads.device):
        sorted_ids, perm = torch.sort(ids, stable=True)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(grads.data_ptr(), dim, sorted_ids.data_ptr(), perm.data_ptr(),
                 n, num_segments, starts.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_rowsum launch failed: CUDA error {err}")
    launches += 1
    return out
