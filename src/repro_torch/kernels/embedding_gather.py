"""Embedding row gather on the card: the wrapper of ``csrc/embedding_gather.cu``.

Replaces the Pallas TPU kernel ``embedding_gather``
(``src/repro/kernels/embedding_gather.py``) and the clamp-then-mask around
it in ``repro.kernels.dispatch.gather_rows``: ``out[i] = table[idx[i]]``,
and a zero row where ``idx[i]`` is negative or ``>= len(table)``, in one
pass, for f32 or bf16 rows. The kernel is bound by memory bandwidth
(``2 * n * D * e + 4 * n`` bytes for e-byte elements, no arithmetic); its
source note says how the design meets that.

``launch_plan`` maps a call's shape to the kernel's launch: work items of
(rows, column chunk), each lane keeping ``LANE_BYTES`` of loads in flight,
a wide row split over several warps, narrow rows sharing a warp, and
blocks of fewer warps when a call has few items. It is a pure function of
the shape, so the CPU tests check it; the wrapper passes it to the kernel.

The CUDA library builds at first use (``kernels/build.py``); nothing here
touches CUDA at import.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import cdiv
from . import build

# Launches of the kernel in this process. Incremented only where the
# kernel launches, so a run can show that its path went through it.
launches = 0

LANE_BYTES = 64  # the loads a lane keeps in flight: four 16-byte vectors
MAX_WARPS_PER_BLOCK = 8
# blocks a call is spread over before its blocks grow past one warp: an
# H100's SMs
SPREAD_BLOCKS = 132
MAX_BLOCKS = 2 ** 31 - 1  # the grid's limit; a grid-stride loop does the rest


class Plan(NamedTuple):
    vec_bytes: int  # bytes a load moves: 16, or one element
    loads: int  # loads a lane keeps in flight
    rows_per_warp: int  # rows an item covers (a power of two, at most 32)
    chunks_per_row: int  # column chunks of a row, one item each
    items: int  # (rows of a warp, column chunk) pairs
    warps_per_block: int
    blocks: int

    @property
    def span(self) -> int:
        """Loads of one row that one item covers (at most: the last chunk
        of a row is cut at its end, and a narrow row leaves some unused)."""
        return 32 * self.loads // self.rows_per_warp

    @property
    def chunk_bytes(self) -> int:
        return self.span * self.vec_bytes


def launch_plan(n: int, dim: int, elem_bytes: int, aligned: bool) -> Plan:
    """The kernel's launch for ``n`` rows of ``dim`` elements of
    ``elem_bytes``; ``aligned`` says both base pointers are 16-byte aligned.
    Rows whose byte width is a multiple of 16 then move in 16-byte vectors,
    others element by element."""
    row_bytes = dim * elem_bytes
    vec = 16 if aligned and row_bytes % 16 == 0 else elem_bytes
    width = row_bytes // vec  # loads a row takes
    loads = LANE_BYTES // vec
    rows_per_warp = 32  # as many as a warp's 32 x loads hold
    while rows_per_warp > 1 and 32 // rows_per_warp * loads < width:
        rows_per_warp //= 2
    chunks = cdiv(width, 32 * loads // rows_per_warp)
    items = cdiv(n, rows_per_warp) * chunks
    warps = MAX_WARPS_PER_BLOCK
    while warps > 1 and cdiv(items, warps) < SPREAD_BLOCKS:
        warps //= 2
    return Plan(vec, loads, rows_per_warp, chunks, items, warps,
                min(cdiv(items, warps), MAX_BLOCKS))


def vector_aligned(table: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether both base pointers are 16-byte aligned."""
    return (table.data_ptr() | out.data_ptr()) % 16 == 0


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        _fn = build.function("embedding_gather", "repro_embedding_gather",
                             [p, i64, i64, i64, p, i64, p, i64, i64, i64, i64,
                              i64, i64, p])
    return _fn


def embedding_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(n, D)`` rows of a contiguous f32 or bf16 ``(R, D)`` CUDA table at
    int32 ``idx``; out-of-range indices give zero rows."""
    global launches
    if not (table.is_cuda and idx.device == table.device):
        raise ValueError(f"embedding_gather needs table and idx on one CUDA "
                         f"device, got {table.device} and {idx.device}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"embedding_gather takes float32 or bfloat16 tables, "
                        f"got {table.dtype}")
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
    if out.numel() == 0:
        return out
    plan = launch_plan(n, dim, table.element_size(), vector_aligned(table, out))
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), rows, dim, table.element_size(),
                 idx.data_ptr(), n, out.data_ptr(), plan.vec_bytes, plan.loads,
                 plan.rows_per_warp, plan.chunks_per_row, plan.warps_per_block,
                 plan.blocks, stream)
    if err != 0:
        raise RuntimeError(f"embedding_gather launch failed: CUDA error {err}")
    launches += 1
    return out
