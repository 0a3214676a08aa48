"""TransformerLM serving (``repro.models.transformer``, the dense (attn, mlp)
stacks): parameter init, the compute-dtype cast, KV caches, prefill and
one KV-cache decode step.

Parameters are JAX's pytree flattened to state-dict names, one stacked
tensor per leaf with the layer axis first, as JAX stacks the repeats of
its layer pattern: ``blocks.{p}.attn.wq`` is ``(n_rep, d, H * hd)`` for
pattern position ``p`` (a dense stack has one position and ``n_rep ==
n_layers``), beside ``final_norm.scale`` and ``head_w``. A layer reads
views of its slices; nothing is copied.

The token embedding is not part of this module: lookups go through the
embedding engine, and the backbone takes ready embeddings. Training (the
loss, the backbone's backward) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from . import layers as L


def _pattern_groups(cfg: ModelConfig):
    """(period, n_rep): layers are stacked as n_rep repeats of the period."""
    plan = cfg.layer_plan
    period = len(cfg.layer_pattern) if cfg.layer_pattern else 1
    return plan[:period], cfg.n_layers // period


def _check_ported(cfg: ModelConfig) -> None:
    pattern, _ = _pattern_groups(cfg)
    for mixer, ffn in pattern:
        if mixer != "attn" or ffn not in ("mlp", "none"):
            raise NotImplementedError(
                f"{cfg.name}: ({mixer}, {ffn}) layers are not ported; the port "
                f"serves dense (attn, mlp) stacks")
    if cfg.encoder is not None or cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: encoders and frontends are not ported")


def init_lm_params(cfg: ModelConfig, *, device, generator: torch.Generator
                   ) -> Dict[str, torch.Tensor]:
    """Normal-init weights in ``cfg.param_dtype`` (ones for norm scales, in
    f32), drawn in place on ``device`` from ``generator``: the shapes and
    scales of JAX's ``init_lm_params``, not its numbers (threefry)."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    pattern, n_rep = _pattern_groups(cfg)
    kw = dict(dtype=dtype, device=device, generator=generator, lead=(n_rep,))
    params: Dict[str, torch.Tensor] = {}

    def norm(prefix, lead=()):
        for k, v in L.init_norm(cfg.d_model, cfg.norm_type, device=device).items():
            params[f"{prefix}.{k}"] = v.expand(*lead, -1).contiguous() if lead else v

    for pos, (_, ffn) in enumerate(pattern):
        pre = f"blocks.{pos}"
        norm(f"{pre}.norm1", (n_rep,))
        for k, v in L.init_attention(cfg.d_model, cfg.attention, **kw).items():
            params[f"{pre}.attn.{k}"] = v
        if ffn != "none":
            norm(f"{pre}.norm2", (n_rep,))
            for k, v in L.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_type, **kw).items():
                params[f"{pre}.mlp.{k}"] = v
    norm("final_norm")
    params["head_w"] = L._normal((cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
                                 dtype=dtype, device=device, generator=generator)
    return params


def _cast_tree(params: Mapping[str, torch.Tensor], dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """f32 leaves of rank above 1 in ``dtype``, the rest as they are (JAX's
    rule on the stacked tree: the per-layer norm scales, (n_rep, d), are
    cast too; ``final_norm.scale`` stays f32). A leaf already in ``dtype``
    is not copied."""
    return {k: v.to(dtype) if (v.dtype == torch.float32 and v.dim() > 1) else v
            for k, v in params.items()}


def _layer(params: Mapping[str, torch.Tensor], pos: int, rep: int):
    """The nested ``{"norm1": {...}, "attn": {...}, ...}`` of layer ``rep`` at
    pattern position ``pos``: views of the stacked leaves."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    prefix = f"blocks.{pos}."
    for name, v in params.items():
        if name.startswith(prefix):
            part, leaf = name[len(prefix):].split(".", 1)
            out.setdefault(part, {})[leaf] = v[rep]
    return out


def _final_norm(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k.split(".", 1)[1]: v for k, v in params.items()
            if k.startswith("final_norm.")}


class LMCache(NamedTuple):
    """Per-pattern-position KV caches stacked over repeats (as params):
    ``caches[p]["k"]`` and ``["v"]`` are (n_rep, B, S, KV, hd). ``length``
    is the number of positions already filled. Decode writes the caches in
    place."""

    caches: Tuple[Dict[str, torch.Tensor], ...]
    length: int


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, *, device) -> LMCache:
    _check_ported(cfg)
    pattern, n_rep = _pattern_groups(cfg)
    a = cfg.attention
    shape = (n_rep, batch, max_len, a.n_kv_heads, a.head_dim)
    return LMCache(tuple({"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
                         for _ in pattern), 0)


def lm_prefill(params: Mapping[str, torch.Tensor], cfg: ModelConfig, emb: torch.Tensor,
               *, cache_len=None) -> Tuple[torch.Tensor, LMCache]:
    """Run the backbone over the prompt embeddings (B, T, D) and build the
    KV cache of ``cache_len`` (default T) positions. Returns (last-token
    logits (B, V) in f32, cache). Each layer's k and v are computed once, by
    ``gqa_attention``, and feed both the attention and the cache (JAX
    computes them twice, to the same numbers)."""
    cdt = getattr(torch, cfg.compute_dtype)
    b, t, _ = emb.shape
    cache = init_lm_cache(cfg, b, cache_len or t, cdt, device=emb.device)
    x = emb.to(cdt)
    positions = torch.arange(t, device=emb.device).expand(b, t)
    pattern, n_rep = _pattern_groups(cfg)
    p = _cast_tree(params, cdt)
    for rep in range(n_rep):
        for pos, (_, ffn) in enumerate(pattern):
            lp = _layer(p, pos, rep)
            h = L.apply_norm(lp["norm1"], x, cfg.norm_eps)
            o, k, v = L.gqa_attention(lp["attn"], h, cfg.attention, positions=positions)
            cache.caches[pos]["k"][rep, :, :t] = k
            cache.caches[pos]["v"][rep, :, :t] = v
            x = x + o
            if ffn != "none":
                h = L.apply_norm(lp["norm2"], x, cfg.norm_eps)
                x = x + L.apply_mlp(lp["mlp"], h, cfg.mlp_type, cfg.activation)
    x = L.apply_norm(_final_norm(p), x, cfg.norm_eps)
    logits = (x[:, -1] @ p["head_w"].to(cdt)).to(torch.float32)
    return logits, cache._replace(length=t)


def lm_decode_step(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                   emb: torch.Tensor, cache: LMCache) -> Tuple[torch.Tensor, LMCache]:
    """One decode step for the new tokens' embeddings (B, 1, D) at position
    ``cache.length``. Returns (logits (B, V) in f32, the cache one longer;
    its tensors are the ones passed in, written in place)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = emb.to(cdt)
    pattern, n_rep = _pattern_groups(cfg)
    p = _cast_tree(params, cdt)
    for rep in range(n_rep):
        for pos, (_, ffn) in enumerate(pattern):
            lp = _layer(p, pos, rep)
            c = cache.caches[pos]
            h = L.apply_norm(lp["norm1"], x, cfg.norm_eps)
            o, _, _ = L.gqa_decode(lp["attn"], h, c["k"][rep], c["v"][rep],
                                   cache.length, cfg.attention)
            x = x + o
            if ffn != "none":
                h = L.apply_norm(lp["norm2"], x, cfg.norm_eps)
                x = x + L.apply_mlp(lp["mlp"], h, cfg.mlp_type, cfg.activation)
    x = L.apply_norm(_final_norm(p), x, cfg.norm_eps)
    logits = (x[:, 0] @ p["head_w"].to(cdt)).to(torch.float32)
    return logits, cache._replace(length=cache.length + 1)
