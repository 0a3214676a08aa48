"""Plain PyTorch versions of the ported kernels: what the CPU path runs and
what each kernel is held against on the card."""
from __future__ import annotations

import torch


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with out-of-range (negative or ``>= R``) -> zero row:
    the contract of ``kernels/embedding_gather.py``."""
    n_rows = table.shape[0]
    valid = (idx >= 0) & (idx < n_rows)
    rows = table.index_select(0, idx.clamp(0, n_rows - 1))
    return torch.where(valid[:, None], rows, rows.new_zeros(()))


def segment_rowsum_ref(grads: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """f32 ``(num_segments, D)`` sums of ``grads`` rows by ``ids``; ids
    outside ``[0, num_segments)`` are dropped: the contract of
    ``kernels/segment_rowsum.py``. On the CPU ``index_add_`` adds in input
    order, as the kernel does; on the card it uses atomics."""
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments, grads.shape[-1]), dtype=torch.float32,
                      device=grads.device)
    return out.index_add_(0, ids[keep].long(), grads[keep].to(torch.float32))


def buffer_sync_ref(active_rows: torch.Tensor, active_accum: torch.Tensor,
                    prefetch_rows: torch.Tensor, prefetch_accum: torch.Tensor,
                    src: torch.Tensor):
    """``(rows, accum)``: the active row and accumulator at ``src[i]`` where
    ``src[i] < Ka`` (negative ``src`` wraps to ``src + Ka``, then clamps at
    0), else the prefetch ones: the contract of ``kernels/buffer_sync.py``."""
    ka = active_rows.shape[0]
    hit = src < ka
    safe = torch.clamp(src.long(), max=ka - 1)
    safe = torch.where(safe < 0, safe + ka, safe).clamp(min=0)
    rows = torch.where(hit[:, None], active_rows[safe], prefetch_rows)
    accum = torch.where(hit, active_accum[safe], prefetch_accum)
    return rows, accum


def embedding_scatter_ref(table: torch.Tensor, table_accum: torch.Tensor,
                          idx: torch.Tensor, rows: torch.Tensor,
                          accum: torch.Tensor) -> None:
    """``table[idx] = rows`` and ``table_accum[idx] = accum`` in place for
    every in-range ``idx`` (distinct); the rest are dropped: the contract of
    ``kernels/embedding_scatter.py``."""
    valid = (idx >= 0) & (idx < table.shape[0])
    dst = idx[valid].long()
    table[dst] = rows[valid]
    table_accum[dst] = accum[valid]
