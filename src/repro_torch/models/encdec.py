"""Encoder-decoder backbone (whisper-base; ``repro.models.encdec``): a
bidirectional encoder over stub audio-frame embeddings and a causal
decoder with cross attention.

The conv frontend is a stub: the batch carries precomputed frames (B,
n_frames, enc_d) in f32, drawn by the stream (training) or by
``Session.serve``; only the transformer backbone is real. The decoder's
token embeddings come from the NestPipe engine like every other LM's.

Parameters are JAX's pytree flattened to state-dict names, each stack's
leaves stacked with the layer axis first: ``encoder.{norm1,attn,norm2,
mlp}.*`` and ``decoder.{norm1,attn,normx,xattn,norm2,mlp}.*``, beside
``enc_norm.{scale,bias}``, ``final_norm.{scale,bias}`` and ``head_w``. A
layer reads views of its slices (``transformer._layers``).

Every full-sequence attention goes through ``dispatch.flash_attention``:
the encoder's self-attention non-causal at T = n_frames, the decoder's
causal, and the cross attention non-causal, its queries at the decoder's
positions against the encoder's n_frames keys (the kv heads read in place,
with no repeat). JAX computes the cross attention with ``naive_attention``,
the same function. Decode's attention is plain PyTorch, as in JAX. RoPE
rotates the self-attention of both stacks (JAX's encoder uses it too, not
Whisper's sinusoids); the cross attention's q and k are not rotated.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import AttentionConfig, ModelConfig
from ..kernels import dispatch
from . import layers as L
from .transformer import _cast_tree, _final_norm, _layers, vocab_parallel_xent


def check_encdec(cfg: ModelConfig) -> None:
    """The encoder-decoder this module computes: an encoder, attention and
    a plain MLP in every layer of both stacks, and no frontend but the
    audio stub (whose frames the batch carries)."""
    if cfg.encoder is None or cfg.attention is None:
        raise NotImplementedError(f"{cfg.name}: not an encoder-decoder")
    if cfg.moe is not None or cfg.mamba is not None or cfg.layer_pattern is not None:
        raise NotImplementedError(f"{cfg.name}: only (attn, mlp) encoder-decoder "
                                  "layers are ported")
    if cfg.frontend is not None and cfg.frontend.kind != "audio":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend.kind} frontend is "
                                  "not ported")


def enc_dim(cfg: ModelConfig) -> int:
    return cfg.encoder.d_model or cfg.d_model


def init_encdec_params(cfg: ModelConfig, *, device, generator: torch.Generator
                       ) -> Dict[str, torch.Tensor]:
    """Normal-init weights in ``cfg.param_dtype`` (LayerNorm scales and
    biases in f32), drawn in place on ``device`` from ``generator``: the
    shapes and scales of JAX's ``init_encdec_params``, not its numbers
    (threefry); ``head_w`` scaled by ``d_model ** -0.5``."""
    check_encdec(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    params: Dict[str, torch.Tensor] = {}

    def stack(prefix, d, n, parts):
        kw = dict(dtype=dtype, device=device, generator=generator, lead=(n,))
        for part in parts:
            if part.startswith("norm"):
                leaves = L.init_norm(d, cfg.norm_type, device=device)
                leaves = {k: v.expand(n, -1).contiguous() for k, v in leaves.items()}
            elif part.endswith("attn"):
                leaves = L.init_attention(d, cfg.attention, **kw)
            else:
                leaves = L.init_mlp(d, cfg.d_ff, cfg.mlp_type, **kw)
            for k, v in leaves.items():
                params[f"{prefix}.{part}.{k}"] = v

    stack("encoder", enc_dim(cfg), cfg.encoder.n_layers, ("norm1", "attn", "norm2", "mlp"))
    stack("decoder", cfg.d_model, cfg.n_layers,
          ("norm1", "attn", "normx", "xattn", "norm2", "mlp"))
    for name, d in (("enc_norm", enc_dim(cfg)), ("final_norm", cfg.d_model)):
        for k, v in L.init_norm(d, cfg.norm_type, device=device).items():
            params[f"{name}.{k}"] = v
    params["head_w"] = L._normal((cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
                                 dtype=dtype, device=device, generator=generator)
    return params


def _memory_kv(p: Mapping[str, torch.Tensor], mem: torch.Tensor, acfg: AttentionConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross attention's k and v of the encoder memory (B, Tm, D): (B,
    Tm, KV, hd) each, not rotated. JAX repeats them to H heads; the port's
    attention reads each kv head in place."""
    b, tm, _ = mem.shape
    k = (mem @ p["wk"]).reshape(b, tm, acfg.n_kv_heads, acfg.head_dim)
    v = (mem @ p["wv"]).reshape(b, tm, acfg.n_kv_heads, acfg.head_dim)
    return k, v


def _cross_attention(p: Mapping[str, torch.Tensor], x: torch.Tensor, mem_k: torch.Tensor,
                     mem_v: torch.Tensor, acfg: AttentionConfig, *,
                     decode: bool = False) -> torch.Tensor:
    """Queries of x (B, Tq, D) against the memory's k and v (B, Tm, KV,
    hd), no mask: ``dispatch.flash_attention`` over a sequence (training,
    the prefill), the plain ``naive_attention`` in a decode step."""
    b, t, _ = x.shape
    q = (x @ p["wq"]).reshape(b, t, acfg.n_heads, acfg.head_dim)
    if decode:
        o = L.naive_attention(q, mem_k, mem_v, causal=False)
    else:
        o = dispatch.flash_attention(q, mem_k, mem_v, causal=False)
    return o.reshape(b, t, -1) @ p["wo"]


def _remat(fn: Callable, x: torch.Tensor, *args):
    """``fn(x, *args)`` under a non-reentrant ``checkpoint`` when grad is on
    (training keeps only the layer boundaries and runs each layer's forward
    again in the backward, as ``lm_backbone`` does), else plainly."""
    if torch.is_grad_enabled():
        return checkpoint(fn, x, *args, use_reentrant=False)
    return fn(x, *args)


def _encoder_layer(lp, cfg: ModelConfig, acfg: AttentionConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(lp["norm1"], x, cfg.norm_eps)
    x = x + L.gqa_attention(lp["attn"], h, acfg, positions=positions)[0]
    h = L.apply_norm(lp["norm2"], x, cfg.norm_eps)
    return x + L.apply_mlp(lp["mlp"], h, cfg.mlp_type, cfg.activation)


def _decoder_layer(lp, cfg: ModelConfig, x: torch.Tensor, mem: torch.Tensor,
                   positions: torch.Tensor):
    """One decoder layer on x (B, T, D) against the memory (B, Tm, D):
    ``(x, (k, v), (mem_k, mem_v))``, the self-attention's rotated k and v
    and the cross attention's memory k and v, which a prefill caches."""
    h = L.apply_norm(lp["norm1"], x, cfg.norm_eps)
    o, k, v = L.gqa_attention(lp["attn"], h, cfg.attention, positions=positions)
    x = x + o
    h = L.apply_norm(lp["normx"], x, cfg.norm_eps)
    mk, mv = _memory_kv(lp["xattn"], mem, cfg.attention)
    x = x + _cross_attention(lp["xattn"], h, mk, mv, cfg.attention)
    h = L.apply_norm(lp["norm2"], x, cfg.norm_eps)
    x = x + L.apply_mlp(lp["mlp"], h, cfg.mlp_type, cfg.activation)
    return x, (k, v), (mk, mv)


def run_encoder(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                frames: torch.Tensor) -> torch.Tensor:
    """frames (B, n_frames, enc_d), the stub frontend's output -> the
    encoder memory (B, n_frames, enc_d) in the compute dtype: each layer
    self-attends without a mask at positions 0..n_frames-1, then
    ``enc_norm``."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = frames.to(cdt)
    p = _cast_tree(params, cdt)
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device).expand(b, t)
    acfg = dataclasses.replace(cfg.attention, causal=False)
    for lp in _layers(p, "encoder."):
        x = _remat(lambda x_, lp=lp: _encoder_layer(lp, cfg, acfg, x_, positions), x)
    return L.apply_norm(_final_norm(p, "enc_norm"), x, cfg.norm_eps)


def run_decoder(params: Mapping[str, torch.Tensor], cfg: ModelConfig, emb: torch.Tensor,
                memory: torch.Tensor) -> torch.Tensor:
    """The decoder over ready token embeddings (B, T, D) against the encoder
    memory: the hidden states (B, T, D) after ``final_norm``, in the
    compute dtype."""
    cdt = getattr(torch, cfg.compute_dtype)
    x, mem = emb.to(cdt), memory.to(cdt)
    p = _cast_tree(params, cdt)
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device).expand(b, t)
    for lp in _layers(p, "decoder."):
        x = _remat(lambda x_, m_, lp=lp: _decoder_layer(lp, cfg, x_, m_, positions)[0],
                   x, mem)
    return L.apply_norm(_final_norm(p), x, cfg.norm_eps)


def make_encdec_loss_fn(cfg: ModelConfig, *, t_chunk: int = 512) -> Callable:
    """``loss_fn(params, emb, mb) -> (loss, {"xent"})`` with ``mb = {"frames",
    "labels"}``: the encoder over the frames, the decoder over the token
    embeddings, the chunked next-token cross-entropy with ``head_w`` in the
    compute dtype."""
    check_encdec(cfg)
    cdt = getattr(torch, cfg.compute_dtype)

    def loss_fn(params, emb, mb):
        memory = run_encoder(params, cfg, mb["frames"])
        hidden = run_decoder(params, cfg, emb, memory)
        loss = vocab_parallel_xent(hidden, params["head_w"].to(cdt), mb["labels"],
                                   t_chunk=t_chunk)
        return loss, {"xent": loss.detach()}

    return loss_fn


# ---------------------------------------------------------------------------
# Serving: the caches, prefill, decode
# ---------------------------------------------------------------------------


class EncDecCache(NamedTuple):
    """The decoder's caches, stacked over its layers, in the compute dtype:
    ``self_k`` and ``self_v`` (L, B, S, KV, hd), the self-attention's rotated
    k and v; ``mem_k`` and ``mem_v`` (L, B, Tm, KV, hd), the cross
    attention's k and v of the encoder memory, computed once in the prefill
    (KV = H at whisper: JAX's H-head shape). ``length`` is the number of
    positions filled. Decode writes ``self_k`` and ``self_v`` in place."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    mem_k: torch.Tensor
    mem_v: torch.Tensor
    length: int


def encdec_prefill(params: Mapping[str, torch.Tensor], cfg: ModelConfig, emb: torch.Tensor,
                   frames: torch.Tensor, *, cache_len: Optional[int] = None
                   ) -> Tuple[torch.Tensor, EncDecCache]:
    """The encoder over ``frames``, then the decoder over the prompt
    embeddings (B, T, D), building caches of ``cache_len`` (default T)
    positions. Returns (last-token logits (B, V) in f32, cache). Each
    layer's self k and v and memory k and v are computed once and feed both
    the attention and the cache."""
    cdt = getattr(torch, cfg.compute_dtype)
    memory = run_encoder(params, cfg, frames)
    a = cfg.attention
    b, t, _ = emb.shape
    n, tm = cfg.n_layers, memory.shape[1]
    kw = dict(dtype=cdt, device=emb.device)
    self_k = torch.zeros((n, b, cache_len or t, a.n_kv_heads, a.head_dim), **kw)
    self_v = torch.zeros_like(self_k)
    mem_k = torch.empty((n, b, tm, a.n_kv_heads, a.head_dim), **kw)
    mem_v = torch.empty_like(mem_k)
    p = _cast_tree(params, cdt)
    x = emb.to(cdt)
    positions = torch.arange(t, device=emb.device).expand(b, t)
    for i, lp in enumerate(_layers(p, "decoder.")):
        x, (k, v), (mk, mv) = _decoder_layer(lp, cfg, x, memory, positions)
        self_k[i, :, :t], self_v[i, :, :t] = k, v
        mem_k[i], mem_v[i] = mk, mv
    x = L.apply_norm(_final_norm(p), x, cfg.norm_eps)
    logits = (x[:, -1] @ p["head_w"].to(cdt)).to(torch.float32)
    return logits, EncDecCache(self_k, self_v, mem_k, mem_v, t)


def encdec_decode_step(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                       emb: torch.Tensor, cache: EncDecCache
                       ) -> Tuple[torch.Tensor, EncDecCache]:
    """One decode step for the new tokens' embeddings (B, 1, D) at position
    ``cache.length``: the self-attention against the self caches (written in
    place), the cross attention against the memory caches, both plain
    PyTorch. Returns (logits (B, V) in f32, the cache one longer)."""
    cdt = getattr(torch, cfg.compute_dtype)
    p = _cast_tree(params, cdt)
    x = emb.to(cdt)
    a = cfg.attention
    for i, lp in enumerate(_layers(p, "decoder.")):
        h = L.apply_norm(lp["norm1"], x, cfg.norm_eps)
        o, _, _ = L.gqa_decode(lp["attn"], h, cache.self_k[i], cache.self_v[i],
                               cache.length, a)
        x = x + o
        h = L.apply_norm(lp["normx"], x, cfg.norm_eps)
        x = x + _cross_attention(lp["xattn"], h, cache.mem_k[i].to(cdt),
                                 cache.mem_v[i].to(cdt), a, decode=True)
        h = L.apply_norm(lp["norm2"], x, cfg.norm_eps)
        x = x + L.apply_mlp(lp["mlp"], h, cfg.mlp_type, cfg.activation)
    x = L.apply_norm(_final_norm(p), x, cfg.norm_eps)
    logits = (x[:, 0] @ p["head_w"].to(cdt)).to(torch.float32)
    return logits, cache._replace(length=cache.length + 1)
