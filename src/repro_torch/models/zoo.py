"""Model zoo adapter, LM branches (``repro.models.zoo``, ``kind == "lm"``,
a VLM among them, and ``kind == "encdec"``): one interface over an LM or
encoder-decoder config for the training and serving paths, and their
training batch shapes."""
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
    layers the port lacks. A VLM's loss (a vision ``cfg.frontend``) runs
    the LM loss over its micro-batch's ``patches``, cast to the lookup's
    dtype, ahead of the text embeddings along T, with ``labels`` over both
    (JAX's ``zoo.py``); its prefill takes the two already concatenated
    (``Session.serve``)."""
    TF._check_ported(cfg)

    def init_params(generator: torch.Generator, device):
        return TF.init_lm_params(cfg, device=device, generator=generator)

    def loss_fn(t_chunk: int):
        base = TF.make_lm_loss_fn(cfg, t_chunk=t_chunk)
        if cfg.frontend is None:
            return base

        def vlm_loss(params, emb, mb):
            full = torch.cat([mb["patches"].to(emb.dtype), emb], dim=1)
            return base(params, full, {"labels": mb["labels"]})

        return vlm_loss

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
    """{field: ((N, mb, ...), dtype)} for one LM training window (the LM,
    encdec and VLM cases of JAX's ``train_batch_shapes``): token keys and
    next-token labels, and between them, for an encoder-decoder ``cfg``, the
    frames (N, mb, n_frames, enc_d) in f32. A VLM's ``seq_len`` positions
    are its ``n_positions`` patches (N, mb, n_positions, d_model) in f32,
    then ``seq_len - n_positions`` text keys; its labels cover all
    ``seq_len``."""
    mb = global_batch // n_micro
    t_text = seq_len
    if cfg.encoder is None and cfg.frontend is not None:
        t_text = seq_len - cfg.frontend.n_positions
        if t_text < 1:
            raise ValueError(f"{cfg.name}: seq_len {seq_len} leaves no text after its "
                             f"{cfg.frontend.n_positions} patches")
    shapes = {"keys": ((n_micro, mb, t_text), torch.int32)}
    if cfg.encoder is not None:
        shapes["frames"] = ((n_micro, mb, cfg.encoder.n_frames, ED.enc_dim(cfg)),
                            torch.float32)
    elif cfg.frontend is not None:
        shapes["patches"] = ((n_micro, mb, cfg.frontend.n_positions, cfg.d_model),
                             torch.float32)
    shapes["labels"] = ((n_micro, mb, seq_len), torch.int32)
    return shapes
