"""The one place that decides how the engine's gathers run.

The tensor's device decides: a CPU tensor goes to the plain PyTorch
version (``ref.py``), a CUDA tensor to the hand-written kernel, which runs
or raises. There is no backend switch and no fallback, so on the card
the path always runs the kernel.

Contract (the sentinel convention of ``repro.kernels.dispatch``):
``gather_rows(rows, idx)`` returns ``rows[idx]`` with a zero row for every
out-of-range index (sentinel slots, ``idx >= len(rows)``, or negative).
"""
from __future__ import annotations

import torch

from . import ref
from .embedding_gather import embedding_gather


def gather_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows[idx]`` with out-of-range -> zero row (sentinel-safe gather)."""
    if rows.is_cuda:
        return embedding_gather(rows, idx)
    if rows.device.type == "cpu" and idx.device.type == "cpu":
        return ref.gather_rows_ref(rows, idx)
    raise ValueError(f"gather_rows: no path for rows on {rows.device} "
                     f"and idx on {idx.device}")
