"""In-place embedding row scatter on the card: the wrapper of ``csrc/embedding_scatter.cu``.

The master write-back of a DBP commit: ``table[idx[i]] = rows[i]`` and
``table_accum[idx[i]] = accum[i]`` for every in-range ``idx[i]``;
out-of-range slots (the buffer's sentinel padding) write nothing. It ports
the XLA scatter ``.at[idx].set(..., mode="drop")`` of
``repro.core.embedding.engine.EmbeddingEngine.writeback``, which has no
Pallas kernel: torch has no scatter that drops out-of-range targets, and
masking them first would need a device sync per step. The targets must be
distinct (a buffer's keys are unique), which makes the result
deterministic. Bound by memory bandwidth; see the source note.

The CUDA library builds at first use (``kernels/build.py``); nothing here
touches CUDA at import.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build

# Launches of the kernel in this process. Incremented only where the
# kernel launches, so a run can show that its path went through it. The
# async stage executor's workers launch it too: the count takes a lock.
launches = 0
_launches_lock = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        _fn = build.function("embedding_scatter", "repro_embedding_scatter_f32",
                             [p, p, i64, i64, p, p, p, i64, p])
    return _fn


def embedding_scatter(table: torch.Tensor, table_accum: torch.Tensor,
                      idx: torch.Tensor, rows: torch.Tensor,
                      accum: torch.Tensor) -> None:
    """Write ``rows`` (n, D) and ``accum`` (n,) into ``table`` (R, D) and
    ``table_accum`` (R,) at the distinct int32 ``idx`` (n,), in place;
    out-of-range indices are dropped. All contiguous, on one CUDA device."""
    global launches
    tensors = (table, table_accum, idx, rows, accum)
    if not all(t.is_cuda and t.device == table.device for t in tensors):
        raise ValueError("embedding_scatter needs every tensor on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in (table, table_accum, rows, accum)):
        raise TypeError("embedding_scatter takes float32 rows and accumulators")
    if idx.dtype != torch.int32:
        raise TypeError(f"embedding_scatter takes int32 indices, got {idx.dtype}")
    r, dim = table.shape if table.dim() == 2 else (-1, -1)
    n = idx.shape[0] if idx.dim() == 1 else -1
    if (r < 0 or n < 0 or tuple(table_accum.shape) != (r,)
            or tuple(rows.shape) != (n, dim) or tuple(accum.shape) != (n,)):
        raise ValueError("embedding_scatter takes (R, D), (R,), (n,), (n, D), "
                         f"(n,), got {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("embedding_scatter takes contiguous tensors")
    if n == 0:
        return
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), table_accum.data_ptr(), r, dim,
                 idx.data_ptr(), rows.data_ptr(), accum.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"embedding_scatter launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
