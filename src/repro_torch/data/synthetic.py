"""Synthetic recsys streams with production-like sparsity (a numpy copy of
``repro.data.synthetic``: the same seed gives byte-equal batches).

Zipf-distributed categorical keys over multiple tables with labels from a
planted logistic model (DLRM), and zipf id sequences (HSTU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..configs.base import RecsysModelConfig


def _zipf(rng: np.random.Generator, n: int, size, a: float = 1.2) -> np.ndarray:
    """Zipf-ish sampler over [0, n) via inverse-CDF on a truncated power law."""
    u = rng.random(size)
    # inverse CDF of p(k) ~ (k+1)^-a on [0, n)
    if a == 1.0:
        k = np.exp(u * np.log(n)) - 1
    else:
        k = ((n ** (1 - a) - 1) * u + 1) ** (1 / (1 - a)) - 1
    return np.clip(k.astype(np.int64), 0, n - 1)


@dataclass
class RecsysBatch:
    """Host-side batch: per-table keys already mapped to mega-table ids."""

    keys: np.ndarray  # (B, F_total) int32 scrambled mega-keys
    dense: np.ndarray  # (B, num_dense) f32
    labels: np.ndarray  # (B,) f32 in {0,1}
    raw_keys: np.ndarray  # (B, F_total) pre-scramble (for clustering stats)


class SyntheticRecsysStream:
    """Deterministic synthetic CTR-style stream for a RecsysModelConfig."""

    def __init__(
        self,
        cfg: RecsysModelConfig,
        mega_spec,  # MegaTableSpec
        global_batch: int,
        *,
        zipf_a: float = 1.2,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.spec = mega_spec
        self.batch = global_batch
        self.zipf_a = zipf_a
        self.seed = seed
        self._feature_slots = []
        for ti, t in enumerate(cfg.tables):
            for _ in range(t.bag_size):
                self._feature_slots.append((ti, t.vocab_size))
        self.f_total = len(self._feature_slots)
        rng = np.random.default_rng(seed + 777)
        self._w = rng.normal(size=(self.f_total,)).astype(np.float32) * 0.5
        self._wd = rng.normal(size=(cfg.num_dense_features,)).astype(np.float32) * 0.5

    def scramble_np(self, keys: np.ndarray) -> np.ndarray:
        """The exact affine scramble, in uint64 (no 32-bit wrap)."""
        s = self.spec
        return ((keys.astype(np.uint64) * s.mix_mult + s.mix_add) % s.padded_rows).astype(
            np.int32
        )

    def make_batch(self, step: int) -> RecsysBatch:
        rng = np.random.default_rng((self.seed, step))
        B = self.batch
        raw = np.empty((B, self.f_total), np.int64)
        # drift rotates the zipf rank->key mapping every step; growth
        # confines sampling to a live prefix. Both consume the same rng
        # draws as the stationary stream, so zeros reproduce it exactly.
        drift = self.cfg.drift_keys_per_step
        grow = self.cfg.growth_keys_per_step
        base = self.cfg.growth_base_keys
        for j, (ti, vocab) in enumerate(self._feature_slots):
            live = vocab
            if grow or base:
                live = int(np.clip(base + step * grow, 1, vocab))
            r = _zipf(rng, live, B, self.zipf_a)
            if drift:
                r = (r + step * drift) % vocab
            raw[:, j] = r + self.spec.table_offsets[ti]
        dense = rng.normal(size=(B, self.cfg.num_dense_features)).astype(np.float32)
        # planted logistic labels keyed on (key parity patterns + dense)
        logit = ((raw % 7 - 3) * self._w).sum(1) * 0.6 + dense @ self._wd * 1.0
        labels = (rng.random(B) < 1 / (1 + np.exp(-logit))).astype(np.float32)
        return RecsysBatch(
            keys=self.scramble_np(raw),
            dense=dense,
            labels=labels,
            raw_keys=raw.astype(np.int64),
        )


class SyntheticLMStream:
    """Zipf id-sequence stream (the HSTU item sequences): batches of
    (keys, raw_tokens, labels), ``labels`` the sequence shifted by one."""

    def __init__(
        self,
        vocab_size: int,
        mega_spec,  # MegaTableSpec
        global_batch: int,
        seq_len: int,
        *,
        zipf_a: float = 1.1,
        seed: int = 0,
    ):
        self.vocab = vocab_size
        self.spec = mega_spec
        self.batch = global_batch
        self.seq = seq_len
        self.zipf_a = zipf_a
        self.seed = seed

    def scramble_np(self, keys: np.ndarray) -> np.ndarray:
        """The exact affine scramble, in uint64 (no 32-bit wrap)."""
        s = self.spec
        return ((keys.astype(np.uint64) * s.mix_mult + s.mix_add) % s.padded_rows).astype(
            np.int32
        )

    def make_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = _zipf(rng, self.vocab, (self.batch, self.seq + 1), self.zipf_a)
        return {
            "keys": self.scramble_np(toks[:, :-1]),
            "raw_tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
