"""Model zoo adapter, LM branch (``repro.models.zoo``, ``kind == "lm"``):
one interface over a dense LM config for the serving path."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ModelConfig
from . import transformer as TF


@dataclass
class LMBundle:
    init_params: Callable  # (generator, device) -> params
    prefill: Callable  # (params, emb, cache_len=) -> (logits, cache)
    decode_step: Callable  # (params, emb, cache) -> (logits, cache)
    init_cache: Callable  # (batch, max_len, dtype, device) -> cache
    emb_dim: int


def build_lm_bundle(cfg: ModelConfig) -> LMBundle:
    """The serving half of JAX's LM bundle (the loss belongs to LM
    training, which is not ported). Refuses configs whose layers the port
    lacks."""
    TF._check_ported(cfg)

    def init_params(generator: torch.Generator, device):
        return TF.init_lm_params(cfg, device=device, generator=generator)

    def prefill(params, emb, **kw):
        return TF.lm_prefill(params, cfg, emb, **kw)

    def decode(params, emb, cache):
        return TF.lm_decode_step(params, cfg, emb, cache)

    def init_cache(batch, max_len, dtype=torch.bfloat16, *, device):
        return TF.init_lm_cache(cfg, batch, max_len, dtype, device=device)

    return LMBundle(init_params=init_params, prefill=prefill, decode_step=decode,
                    init_cache=init_cache, emb_dim=cfg.d_model)
