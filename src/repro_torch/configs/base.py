"""Config dataclasses for the recsys models, the NestPipe switches the
serving and training paths read, and the optimizer (field-for-field copies
of ``repro.configs.base``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class SparseTableConfig:
    name: str
    vocab_size: int
    dim: int
    # multi-hot bag size per sample (1 => one-hot feature)
    bag_size: int = 1
    combiner: str = "sum"  # "sum" | "mean"


@dataclass(frozen=True)
class RecsysModelConfig:
    name: str
    backbone: str  # "hstu" | "fuxi" | "dlrm"
    tables: Tuple[SparseTableConfig, ...]
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    seq_len: int  # behaviour-sequence length
    num_dense_features: int = 16
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # Zipf exponent of the synthetic key stream (data/synthetic).
    zipf_a: float = 1.2
    # Non-stationary key streams (data/synthetic): drift rotates the zipf
    # rank->key mapping every step; growth confines sampling to a live
    # prefix that widens every step. Zeros give the stationary stream.
    drift_keys_per_step: int = 0
    growth_keys_per_step: int = 0
    growth_base_keys: int = 0

    @property
    def total_sparse_rows(self) -> int:
        return sum(t.vocab_size for t in self.tables)

    @property
    def max_table_dim(self) -> int:
        return max(t.dim for t in self.tables)


@dataclass(frozen=True)
class NestPipeConfig:
    """The NestPipe switches the serving path and the DBP driver read."""

    fwp_microbatches: int = 4  # N; 1 disables FWP
    clustering: str = "keycentric"  # "keycentric" | "none"
    # Fixed-capacity routing knobs (static shapes).
    unique_capacity_factor: float = 1.0  # U_max = ceil(L * factor)
    bucket_slack: float = 1.5  # C = ceil(U_max / S * slack)
    # Embedding storage tier: "auto" resolves to "device"; "host" and
    # "cached" are not ported yet (core/store/base.py raises).
    store: str = "auto"
    # DBP lookahead depth k: the Prefetcher routes and retrieves step t+k
    # while step t computes (k=1 is the paper's dual-buffer setting).
    prefetch_ahead: int = 1


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # dense optimizer
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    # Sparse (embedding) optimizer — rowwise to bound state size.
    sparse_name: str = "rowwise_adagrad"
    sparse_lr: float = 0.05
    sparse_eps: float = 1e-8
    # Moment dtype policy: "f32" always; params bf16 + no master copy for huge archs.
    master_copy: bool = True
