"""The one place that decides how the engine's hot-path ops run.

The tensor's device decides: a CPU tensor goes to the plain PyTorch
version (``ref.py``), a CUDA tensor to the hand-written kernel, which runs
or raises. There is no backend switch and no fallback, so on the card
the path always runs the kernels.

Contract (the sentinel conventions of ``repro.kernels.dispatch``):

- ``gather_rows(rows, idx)`` returns ``rows[idx]`` (f32 or bf16 rows)
  with a zero row for every out-of-range index (sentinel slots,
  ``idx >= len(rows)``, or negative).
- ``segment_rowsum(values, ids, S)`` sums rows into ``(S, D)`` f32
  buckets; ids outside ``[0, S)`` are dropped. Ids need not be sorted.
  (JAX's reference backend wraps a negative id to the last segment; its
  Pallas kernel drops it, as the port does.)
- ``buffer_sync(ar, aa, pr, pa, src)`` takes the active row and adagrad
  state where ``src[i] < len(ar)``, else the prefetch ones.
- ``scatter_rows(table, table_accum, idx, rows, accum)`` writes rows and
  state into the master in place at distinct in-range ``idx``; the rest
  are dropped.
- ``hstu_attention(q, k, v, causal)`` is HSTU's pointwise attention,
  differentiable: the CUDA forward and backward kernels on the card, the
  plain version under autograd on the CPU.
- ``flash_attention(q, k, v, causal)`` is softmax attention for q
  ``(B, Tq, H, hd)`` and k, v ``(B, Tk, KV, hd)`` with ``H % KV == 0``,
  differentiable: on the card, when grad is on and an input requires it,
  a forward kernel that writes the row logsumexp (f32 at hd <= 128: the
  3xTF32 kernel; bf16 at a wgmma head dim: the wgmma kernel) and the
  backward kernel (``FlashAttention``; FuXi's and the LMs' training),
  else the forward kernel alone (the serving path); the plain version
  under autograd on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import ref
from .buffer_sync import buffer_sync as _buffer_sync_kernel
from .embedding_gather import embedding_gather
from .embedding_scatter import embedding_scatter
from .flash_attention import FlashAttention
from .flash_attention import flash_attention as _flash_attention_kernel
from .hstu_attention import HSTUAttention
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


def hstu_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """``sum_j m(i,j) silu(q_i . k_j / sqrt(dqk)) / T v_j`` for q, k
    ``(B, T, H, dqk)`` and v ``(B, T, H, dv)``; ``m`` masks keys past the
    query when ``causal``."""
    if q.is_cuda:
        return HSTUAttention.apply(q, k, v, causal)
    if _on_cpu(q, k, v):
        return ref.hstu_attention_ref(q, k, v, causal)
    raise _no_path("hstu_attention", q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """``softmax(q k^T / sqrt(hd)) v`` per head, keys after the query masked
    when ``causal``; q ``(B, Tq, H, hd)``, k and v ``(B, Tk, KV, hd)``, query
    head ``h`` reading kv head ``h // (H // KV)``."""
    if q.is_cuda:
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            return FlashAttention.apply(q, k, v, causal)
        return _flash_attention_kernel(q, k, v, causal)
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal)
    raise _no_path("flash_attention", q, k, v)
