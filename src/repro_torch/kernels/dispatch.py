"""The one place that decides how the engine's hot-path ops run.

The tensor's device decides: a CPU tensor goes to the plain PyTorch
version (``ref.py``), a CUDA tensor to the hand-written kernel, which runs
or raises. There is no backend switch and no fallback, so on the card
the path always runs the kernels.

Contract (the sentinel conventions of ``repro.kernels.dispatch``):

- ``gather_rows(rows, idx)`` returns ``rows[idx]`` with a zero row for
  every out-of-range index (sentinel slots, ``idx >= len(rows)``, or
  negative).
- ``segment_rowsum(values, ids, S)`` sums rows into ``(S, D)`` f32
  buckets; ids outside ``[0, S)`` are dropped. Ids need not be sorted.
  (JAX's reference backend wraps a negative id to the last segment; its
  Pallas kernel drops it, as the port does.)
- ``buffer_sync(ar, aa, pr, pa, src)`` takes the active row and adagrad
  state where ``src[i] < len(ar)``, else the prefetch ones.
- ``scatter_rows(table, table_accum, idx, rows, accum)`` writes rows and
  state into the master in place at distinct in-range ``idx``; the rest
  are dropped.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import ref
from .buffer_sync import buffer_sync as _buffer_sync_kernel
from .embedding_gather import embedding_gather
from .embedding_scatter import embedding_scatter
from .segment_rowsum import segment_rowsum as _segment_rowsum_kernel


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _no_path(op: str, *tensors: torch.Tensor) -> ValueError:
    return ValueError(f"{op}: no path for tensors on "
                      f"{[str(t.device) for t in tensors]}")


def gather_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows[idx]`` with out-of-range -> zero row (sentinel-safe gather)."""
    if rows.is_cuda:
        return embedding_gather(rows, idx)
    if _on_cpu(rows, idx):
        return ref.gather_rows_ref(rows, idx)
    raise _no_path("gather_rows", rows, idx)


def segment_rowsum(values: torch.Tensor, ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Sum (L, D) rows into (num_segments, D) f32 buckets; ids outside
    ``[0, num_segments)`` drop."""
    if values.is_cuda:
        return _segment_rowsum_kernel(values, ids, num_segments)
    if _on_cpu(values, ids):
        return ref.segment_rowsum_ref(values, ids, num_segments)
    raise _no_path("segment_rowsum", values, ids)


def buffer_sync(active_rows: torch.Tensor, active_accum: torch.Tensor,
                prefetch_rows: torch.Tensor, prefetch_accum: torch.Tensor,
                src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """DBP intersection copy: ``src[i] < len(active)`` picks the active row
    and accumulator, anything else keeps the prefetch ones."""
    args = (active_rows, active_accum, prefetch_rows, prefetch_accum, src)
    if active_rows.is_cuda:
        return _buffer_sync_kernel(*args)
    if _on_cpu(*args):
        return ref.buffer_sync_ref(*args)
    raise _no_path("buffer_sync", *args)


def scatter_rows(table: torch.Tensor, table_accum: torch.Tensor,
                 idx: torch.Tensor, rows: torch.Tensor,
                 accum: torch.Tensor) -> None:
    """In place: ``table[idx] = rows``, ``table_accum[idx] = accum`` at
    distinct in-range ``idx``; out-of-range slots drop."""
    args = (table, table_accum, idx, rows, accum)
    if table.is_cuda:
        return embedding_scatter(*args)
    if _on_cpu(*args):
        return ref.embedding_scatter_ref(*args)
    raise _no_path("scatter_rows", *args)
