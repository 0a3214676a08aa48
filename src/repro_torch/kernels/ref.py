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
