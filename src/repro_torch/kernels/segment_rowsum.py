"""Sparse-gradient segment sum on the card: the wrapper of ``csrc/segment_rowsum.cu``.

Replaces the Pallas TPU kernel ``segment_rowsum_sorted``
(``src/repro/kernels/segment_rowsum.py``): ``out[s]`` is the f32 sum of
the ``grads`` rows whose id is ``s``, for ``s`` in ``[0, S)``; ids outside
that range are dropped. Ids need not be sorted. The result is
deterministic, without atomics. The op runs in four parts, each a function
here so that its time can be taken alone:

1. ``sort_ids``: a stable integer sort of the ids (``torch.sort``),
   preparation that the TPU kernel's body does not need and whose time
   counts in this op's;
2. ``find_starts``: a kernel finds each segment's run in the sorted ids;
3. ``sum_chunks``: a kernel cuts each run into chunks of ``CHUNK``
   consecutive positions and sums every chunk in ascending position (chunk
   0 into ``out``, the others into scratch);
4. ``combine``: a kernel adds each long run's partials to ``out`` in
   chunk order.

So a segment's sum is ``((c0 + c1) + c2) + ...`` over its chunks, each
chunk summed in ascending input position: the order of
``ref.segment_rowsum_chunked_ref``, and for a run of at most ``CHUNK``
positions the order of a sequential scatter-add (``ref.segment_rowsum_ref``
on the CPU). The op is bound by memory bandwidth (each in-range row read
once, each output row written once); the source note says how the design
meets that.

The CUDA library builds at first use (``kernels/build.py``); nothing here
touches CUDA at import.
"""
from __future__ import annotations

import ctypes
import torch

from . import build

# Launches of the op in this process. Incremented only where its kernels
# launch, so a run can show that its path went through them.
launches = 0

# Positions per chunk, the unit of the summation order; the kernels take it
# as an argument. A chunk's rows are one dependent chain of loads, so a hot
# key's run is cut this fine (the TPU kernel's blocks hold 256 rows).
CHUNK = 64

_fns = {}


def _kernel(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        argtypes = {
            "repro_segment_starts": [p, i64, i64, p, p],
            "repro_segment_chunks_f32": [p, i64, p, p, p, i64, i64, i64, p, p, p],
            "repro_segment_combine_f32": [p, p, i64, i64, i64, i64, p, p, p],
        }[symbol]
        fn = _fns[symbol] = build.function("segment_rowsum", symbol, argtypes)
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"segment_rowsum {what} launch failed: CUDA error {err}")


def sort_ids(ids: torch.Tensor):
    """``(sorted_ids, perm)``: the stable sort of the ids."""
    return torch.sort(ids, stable=True)


def find_starts(sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``starts`` (S + 1,) int64: the first sorted position whose id is
    ``>= s``."""
    starts = torch.empty((num_segments + 1,), dtype=torch.int64, device=sorted_ids.device)
    _check(_kernel("repro_segment_starts")(
        sorted_ids.data_ptr(), sorted_ids.numel(), num_segments, starts.data_ptr(),
        _stream(sorted_ids)), "starts")
    return starts


def sum_chunks(grads: torch.Tensor, sorted_ids: torch.Tensor, perm: torch.Tensor,
               starts: torch.Tensor, num_segments: int):
    """``(out, partial)``: every run's first chunk summed into ``out``
    (S, D); a later chunk into the row of ``partial`` (ceil(L / CHUNK), D)
    of the stripe of CHUNK sorted positions where it starts."""
    n, dim = grads.shape
    out = torch.empty((num_segments, dim), dtype=torch.float32, device=grads.device)
    partial = torch.empty((-(-n // CHUNK), dim), dtype=torch.float32, device=grads.device)
    _check(_kernel("repro_segment_chunks_f32")(
        grads.data_ptr(), dim, sorted_ids.data_ptr(), perm.data_ptr(), starts.data_ptr(), n,
        num_segments, CHUNK, out.data_ptr(), partial.data_ptr(), _stream(grads)), "chunks")
    return out, partial


def combine(out: torch.Tensor, partial: torch.Tensor, sorted_ids: torch.Tensor,
            starts: torch.Tensor) -> torch.Tensor:
    """``out[s] +=`` the partials of each run longer than CHUNK, in chunk
    order, in place; returns ``out``."""
    _check(_kernel("repro_segment_combine_f32")(
        sorted_ids.data_ptr(), starts.data_ptr(), sorted_ids.numel(), out.shape[0], CHUNK,
        out.shape[1], partial.data_ptr(), out.data_ptr(), _stream(out)), "combine")
    return out


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
    if n == 0 or num_segments == 0 or dim == 0:
        return torch.zeros((num_segments, dim), dtype=torch.float32,
                           device=grads.device)
    with torch.cuda.device(grads.device):
        sorted_ids, perm = sort_ids(ids)
        starts = find_starts(sorted_ids, num_segments)
        out, partial = sum_chunks(grads, sorted_ids, perm, starts, num_segments)
        combine(out, partial, sorted_ids, starts)
    launches += 1
    return out
