"""Model zoo adapter, LM branch (``repro.models.zoo``, ``kind == "lm"``):
one interface over a dense LM config for the training and serving paths,
and the LM's training batch shapes."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import transformer as TF


@dataclass
class LMBundle:
    init_params: Callable  # (generator, device) -> params
    loss_fn: Callable  # (t_chunk) -> loss_fn(params, emb, mb) -> (loss, metrics)
    prefill: Callable  # (params, emb, cache_len=) -> (logits, cache)
    decode_step: Callable  # (params, emb, cache) -> (logits, cache)
    init_cache: Callable  # (batch, max_len, dtype, device) -> cache
    emb_dim: int


def build_lm_bundle(cfg: ModelConfig) -> LMBundle:
    """JAX's LM bundle on one device (no mesh). Refuses configs whose
    layers the port lacks."""
    TF._check_ported(cfg)

    def init_params(generator: torch.Generator, device):
        return TF.init_lm_params(cfg, device=device, generator=generator)

    def loss_fn(t_chunk: int):
        return TF.make_lm_loss_fn(cfg, t_chunk=t_chunk)

    def prefill(params, emb, **kw):
        return TF.lm_prefill(params, cfg, emb, **kw)

    def decode(params, emb, cache):
        return TF.lm_decode_step(params, cfg, emb, cache)

    def init_cache(batch, max_len, dtype=torch.bfloat16, *, device):
        return TF.init_lm_cache(cfg, batch, max_len, dtype, device=device)

    return LMBundle(init_params=init_params, loss_fn=loss_fn, prefill=prefill,
                    decode_step=decode, init_cache=init_cache, emb_dim=cfg.d_model)


def train_batch_shapes(global_batch: int, seq_len: int, n_micro: int
                       ) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """{field: ((N, mb, T), dtype)} for one LM training window (the LM case
    of JAX's ``train_batch_shapes``): token keys and next-token labels."""
    mb = global_batch // n_micro
    return {"keys": ((n_micro, mb, seq_len), torch.int32),
            "labels": ((n_micro, mb, seq_len), torch.int32)}
