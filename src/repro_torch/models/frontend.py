"""Stub modality frontends (``repro.models.frontend``): a VLM's patch
embeddings (and an encoder-decoder's frames) are precomputed inputs, not a
model the port runs. For tests and examples the stub draws them
deterministically from a seed."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig


def frontend_embed_shape(cfg: ModelConfig, batch: int) -> Tuple[int, int, int]:
    """(batch, n_positions, dim): the frontend's feature dim, else the
    encoder's width for an encoder-decoder, else ``d_model``."""
    f = cfg.frontend
    dim = f.feature_dim or (cfg.encoder.d_model or cfg.d_model if cfg.encoder else cfg.d_model)
    return (batch, f.n_positions, dim)


def stub_frontend_embeddings(cfg: ModelConfig, batch: int, seed: int = 0, *,
                             device="cuda") -> torch.Tensor:
    """Pseudo patch or frame embeddings: normals from
    ``np.random.default_rng(seed)`` times 0.02 in f32 (JAX's bits), on
    ``device``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=frontend_embed_shape(cfg, batch)).astype(np.float32) * 0.02
    return torch.as_tensor(x, device=device)
