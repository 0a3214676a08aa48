"""Model zoo adapter, LM branches (``repro.models.zoo``, ``kind == "lm"``
and ``kind == "encdec"``): one interface over an LM or encoder-decoder
config for the training and serving paths, and their training batch
shapes."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import encdec as ED
from . import transformer as TF


@dataclass
class LMBundle:
    init_params: Callable  # (generator, device) -> params
    loss_fn: Callable  # (t_chunk) -> loss_fn(params, emb, mb) -> (loss, metrics)
    prefill: Callable  # (params, emb, [frames=,] cache_len=) -> (logits, cache)
    decode_step: Callable  # (params, emb, cache) -> (logits, cache)
    init_cache: Optional[Callable]  # (batch, max_len, dtype, device) -> cache
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


def build_encdec_bundle(cfg: ModelConfig) -> LMBundle:
    """JAX's encoder-decoder bundle on one device: the prefill takes the
    frames beside the prompt embeddings; no cache of its own to init (the
    prefill builds it), as in JAX."""
    ED.check_encdec(cfg)

    def init_params(generator: torch.Generator, device):
        return ED.init_encdec_params(cfg, device=device, generator=generator)

    def loss_fn(t_chunk: int):
        return ED.make_encdec_loss_fn(cfg, t_chunk=t_chunk)

    def prefill(params, emb, *, frames, cache_len=None):
        return ED.encdec_prefill(params, cfg, emb, frames, cache_len=cache_len)

    def decode(params, emb, cache):
        return ED.encdec_decode_step(params, cfg, emb, cache)

    return LMBundle(init_params=init_params, loss_fn=loss_fn, prefill=prefill,
                    decode_step=decode, init_cache=None, emb_dim=cfg.d_model)


def train_batch_shapes(global_batch: int, seq_len: int, n_micro: int, cfg: ModelConfig
                       ) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """{field: ((N, mb, ...), dtype)} for one LM training window (the LM and
    encdec cases of JAX's ``train_batch_shapes``): token keys and next-token
    labels, and for an encoder-decoder ``cfg`` the frames (N, mb, n_frames,
    enc_d) in f32 between them."""
    mb = global_batch // n_micro
    shapes = {"keys": ((n_micro, mb, seq_len), torch.int32)}
    if cfg.encoder is not None:
        shapes["frames"] = ((n_micro, mb, cfg.encoder.n_frames, ED.enc_dim(cfg)),
                            torch.float32)
    shapes["labels"] = ((n_micro, mb, seq_len), torch.int32)
    return shapes
