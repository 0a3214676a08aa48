"""Embedding-table state: mega-table layout, scrambling, init.

Multiple logical tables are packed into one *mega-table* with per-table
row offsets so a single routing pass serves all tables. Keys are mixed by
an affine scramble over the padded row count Vp:

    scrambled(k) = (k * P + A) mod Vp

computed as ``repro.core.embedding.table.MegaTableSpec.scramble`` computes
it: with ``k * P + A`` wrapped at 32 bits first. That wrap makes the map
not a bijection once ``k * P`` passes 2**32 (dlrm-cached, dlrm-ctr); the
port reproduces it bit for bit so both packages route the same keys to the
same rows. The synthetic stream's ``scramble_np`` uses the exact form.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ...configs.base import SparseTableConfig
from ...utils import coprime_mixer, round_up

_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class MegaTableSpec:
    """Static layout of the packed embedding table."""

    table_names: Tuple[str, ...]
    table_offsets: Tuple[int, ...]  # starting global row per table
    table_vocabs: Tuple[int, ...]
    dim: int
    padded_rows: int  # Vp: total rows rounded up to num_shards
    num_shards: int
    mix_mult: int  # P
    mix_add: int  # A

    @property
    def rows_per_shard(self) -> int:
        return self.padded_rows // self.num_shards

    def scramble(self, keys: torch.Tensor) -> torch.Tensor:
        """``(k * P + A) mod Vp`` with ``k * P + A`` wrapped at uint32, in
        int64 arithmetic (the product is split in 16-bit halves of ``k`` so
        no intermediate passes 2**63)."""
        k = keys.to(torch.int64) & _U32
        p = self.mix_mult & _U32
        lo, hi = k & 0xFFFF, k >> 16
        prod = ((((hi * p) & 0xFFFF) << 16) + lo * p) & _U32
        mixed = ((prod + (self.mix_add & _U32)) & _U32) % (self.padded_rows & _U32)
        return mixed.to(torch.int32)


def make_mega_table_spec(
    tables: Optional[Sequence[SparseTableConfig]], *, num_shards: int,
    vocab_size: Optional[int] = None, dim: Optional[int] = None,
) -> MegaTableSpec:
    """Build the packed spec from recsys table configs, or, with ``tables``
    None, from a single LM vocab (``vocab_size`` rows of ``dim``)."""
    if tables is None:
        if vocab_size is None or dim is None:
            raise ValueError("an LM spec needs vocab_size and dim")
        tables = [SparseTableConfig(name="vocab", vocab_size=vocab_size, dim=dim)]
    names, offsets, vocabs = [], [], []
    off = 0
    max_dim = max(t.dim for t in tables)
    for t in tables:
        names.append(t.name)
        offsets.append(off)
        vocabs.append(t.vocab_size)
        off += t.vocab_size
    padded = round_up(max(off, num_shards), num_shards)
    mult = coprime_mixer(padded)
    add = padded // 7
    return MegaTableSpec(
        table_names=tuple(names),
        table_offsets=tuple(offsets),
        table_vocabs=tuple(vocabs),
        dim=max_dim,
        padded_rows=padded,
        num_shards=num_shards,
        mix_mult=mult,
        mix_add=add,
    )


class EmbeddingTableState(NamedTuple):
    """Master table + rowwise optimizer state.

    ``rows``: (Vp, D); ``accum``: (Vp,) rowwise-adagrad second moment.
    """

    rows: torch.Tensor
    accum: torch.Tensor


def init_table_state(
    spec: MegaTableSpec,
    *,
    device: torch.device | str,
    generator: torch.Generator,
    scale: float = 0.01,
    dtype: torch.dtype = torch.float32,
) -> EmbeddingTableState:
    """Normal(0, scale) rows and zero adagrad state, drawn in place on the
    device so the peak is one table, not two (``dlrm-ctr``: 29.19 GB)."""
    rows = torch.empty((spec.padded_rows, spec.dim), dtype=dtype, device=device)
    rows.normal_(0.0, scale, generator=generator)
    accum = torch.zeros((spec.padded_rows,), dtype=torch.float32, device=device)
    return EmbeddingTableState(rows, accum)
