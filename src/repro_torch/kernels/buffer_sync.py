"""Dual-buffer intersection copy on the card: the wrapper of ``csrc/buffer_sync.cu``.

Replaces the Pallas TPU kernel ``buffer_sync_rows``
(``src/repro/kernels/buffer_sync.py``) and the adagrad-state select beside
it in ``repro.core.embedding.engine.EmbeddingEngine.sync_buffers``: for
each prefetch slot ``i``, ``src[i] < Ka`` takes the active buffer's row and
accumulator at ``src[i]`` (a negative ``src`` wraps to ``src + Ka``),
anything else keeps the prefetch buffer's. Rows and accumulators move in
one pass. The op is bound by memory bandwidth; the source note says how
the design meets that.

The CUDA library builds at first use (``kernels/build.py``); nothing here
touches CUDA at import.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

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
        _fn = build.function("buffer_sync", "repro_buffer_sync_f32",
                             [p, p, i64, p, p, p, i64, i64, p, p, p])
    return _fn


def buffer_sync(active_rows: torch.Tensor, active_accum: torch.Tensor,
                prefetch_rows: torch.Tensor, prefetch_accum: torch.Tensor,
                src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows (Kp, D), accum (Kp,))``: the active buffer's row and
    accumulator at ``src[i]`` where ``src[i] < Ka``, else the prefetch
    buffer's. All tensors contiguous f32 on one CUDA device, ``src`` int32."""
    global launches
    tensors = (active_rows, active_accum, prefetch_rows, prefetch_accum, src)
    if not all(t.is_cuda and t.device == src.device for t in tensors):
        raise ValueError("buffer_sync needs every tensor on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors[:4]):
        raise TypeError("buffer_sync takes float32 rows and accumulators, got "
                        f"{[t.dtype for t in tensors[:4]]}")
    if src.dtype != torch.int32:
        raise TypeError(f"buffer_sync takes int32 src, got {src.dtype}")
    ka, dim = active_rows.shape if active_rows.dim() == 2 else (-1, -1)
    kp = src.shape[0] if src.dim() == 1 else -1
    if (ka < 1 or kp < 0 or tuple(active_accum.shape) != (ka,)
            or tuple(prefetch_rows.shape) != (kp, dim)
            or tuple(prefetch_accum.shape) != (kp,)):
        raise ValueError(
            "buffer_sync takes (Ka, D), (Ka,), (Kp, D), (Kp,), (Kp,) with "
            f"Ka >= 1, got {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("buffer_sync takes contiguous tensors")
    out = torch.empty((kp, dim), dtype=torch.float32, device=src.device)
    out_accum = torch.empty((kp,), dtype=torch.float32, device=src.device)
    if kp == 0:
        return out, out_accum
    fn = _kernel()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(active_rows.data_ptr(), active_accum.data_ptr(), ka,
                 prefetch_rows.data_ptr(), prefetch_accum.data_ptr(),
                 src.data_ptr(), kp, dim, out.data_ptr(), out_accum.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"buffer_sync launch failed: CUDA error {err}")
    launches += 1
    return out, out_accum
