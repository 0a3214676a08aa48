"""TransformerLM (``repro.models.transformer``: (attn | mamba, mlp | moe |
none) stacks, Jamba's hybrid pattern among them): parameter init, the
compute-dtype cast, the training backbone with per-layer remat, the chunked
cross-entropy and the loss the FWP executor takes; caches, prefill and one
decode step.

Parameters are JAX's pytree flattened to state-dict names, one stacked
tensor per leaf with the layer axis first, as JAX stacks the repeats of
its layer pattern: ``blocks.{p}.attn.wq`` is ``(n_rep, d, H * hd)`` for
pattern position ``p`` (a dense stack has one position and ``n_rep ==
n_layers``), beside ``final_norm.scale`` and ``head_w``; an MoE layer's
are ``blocks.{p}.moe.router`` ``(n_rep, d, E)``, ``blocks.{p}.moe.wi``
``(n_rep, E, d, f)`` and so on, a Mamba mixer's ``blocks.{p}.mamba.wz``
``(n_rep, d, d_inner)`` ... ``blocks.{p}.mamba.A_log`` ``(n_rep, H)``. A
layer reads views of its slices (``unbind``, whose gradient stacks the
layers' back into one tensor); nothing is copied.

The token embedding is not part of this module: lookups go through the
embedding engine, and the backbone takes ready embeddings. The training
forward and the prefill run one layer function (``_block``), which
dispatches on the layer's mixer.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import layers as L
from . import mamba as M


def _pattern_groups(cfg: ModelConfig):
    """(period, n_rep): layers are stacked as n_rep repeats of the period."""
    plan = cfg.layer_plan
    period = len(cfg.layer_pattern) if cfg.layer_pattern else 1
    return plan[:period], cfg.n_layers // period


def _check_ported(cfg: ModelConfig) -> None:
    pattern, _ = _pattern_groups(cfg)
    for mixer, ffn in pattern:
        if mixer not in ("attn", "mamba") or ffn not in ("mlp", "moe", "none"):
            raise NotImplementedError(
                f"{cfg.name}: ({mixer}, {ffn}) layers are not ported; the port "
                f"trains and serves (attn | mamba, mlp | moe | none) stacks")
    if cfg.encoder is not None or (cfg.frontend is not None and cfg.frontend.kind != "vision"):
        raise NotImplementedError(
            f"{cfg.name}: encoders and non-vision frontends are not ported in the "
            "decoder-only stack (an encoder-decoder goes through models.encdec)")


def init_lm_params(cfg: ModelConfig, *, device, generator: torch.Generator
                   ) -> Dict[str, torch.Tensor]:
    """Normal-init weights in ``cfg.param_dtype`` (ones for norm scales, in
    f32), drawn in place on ``device`` from ``generator``: the shapes and
    scales of JAX's ``init_lm_params``, not its numbers (threefry). An MoE
    router and a Mamba mixer's ``A_log``, ``D``, ``dt_bias`` and
    ``norm_scale`` are f32 whatever the param dtype, as in JAX."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    pattern, n_rep = _pattern_groups(cfg)
    kw = dict(dtype=dtype, device=device, generator=generator, lead=(n_rep,))
    params: Dict[str, torch.Tensor] = {}

    def norm(prefix, lead=()):
        for k, v in L.init_norm(cfg.d_model, cfg.norm_type, device=device).items():
            params[f"{prefix}.{k}"] = v.expand(*lead, -1).contiguous() if lead else v

    for pos, (mixer, ffn) in enumerate(pattern):
        pre = f"blocks.{pos}"
        norm(f"{pre}.norm1", (n_rep,))
        mix = (L.init_attention(cfg.d_model, cfg.attention, **kw) if mixer == "attn"
               else M.init_mamba(cfg.d_model, cfg.mamba, **kw))
        for k, v in mix.items():
            params[f"{pre}.{mixer}.{k}"] = v
        if ffn == "moe":
            norm(f"{pre}.norm2", (n_rep,))
            for k, v in L.init_moe(cfg.d_model, cfg.d_ff, cfg.moe, cfg.mlp_type,
                                   **kw).items():
                params[f"{pre}.moe.{k}"] = v
        elif ffn != "none":
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


def _layers(params: Mapping[str, torch.Tensor], prefix: str
            ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Per repeat, the nested ``{"norm1": {...}, "attn": {...}, ...}`` of the
    stacked layer under ``prefix`` (``"blocks.{pos}."`` for a pattern
    position; the encoder-decoder's ``"encoder."`` and ``"decoder."``):
    views of the stacked leaves, taken with one ``unbind`` a leaf (its
    gradient is one stack of the layers' gradients, not a stacked-size
    gradient per layer)."""
    out: List[Dict[str, Dict[str, torch.Tensor]]] = []
    for name, v in params.items():
        if name.startswith(prefix):
            part, leaf = name[len(prefix):].split(".", 1)
            for rep, view in enumerate(v.unbind(0)):
                if rep == len(out):
                    out.append({})
                out[rep].setdefault(part, {})[leaf] = view
    return out


def _ffn(lp: Mapping[str, Mapping[str, torch.Tensor]], cfg: ModelConfig, ffn: str,
         x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's second residual branch on x: ``(x, aux)``, aux the MoE's
    load-balance term, None for a layer without one (JAX's ``_apply_block``
    adds a zero there, which changes no sum)."""
    aux = None
    if ffn != "none":
        h = L.apply_norm(lp["norm2"], x, cfg.norm_eps)
        if ffn == "moe":
            y, aux = L.apply_moe(lp["moe"], h, cfg.moe, cfg.mlp_type, cfg.activation)
            x = x + y
        else:
            x = x + L.apply_mlp(lp["mlp"], h, cfg.mlp_type, cfg.activation)
    return x, aux


def _block(lp: Mapping[str, Mapping[str, torch.Tensor]], cfg: ModelConfig, mixer: str,
           ffn: str, x: torch.Tensor, positions: torch.Tensor):
    """One (attn | mamba, mlp | moe | none) layer on x (B, T, D) with its
    weights ``lp``: the pre-norm residual block of JAX's ``_apply_block``.
    Returns ``(x, state, aux)``: state is what a prefill caches, the rotated
    ``(k, v)`` of an attention layer or the ``(conv, ssm)`` state a Mamba
    layer ends on; aux is the MoE term or None (``_ffn``)."""
    h = L.apply_norm(lp["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        o, k, v = L.gqa_attention(lp["attn"], h, cfg.attention, positions=positions)
        state = (k, v)
    else:
        o, state = M.mamba_mixer(lp["mamba"], h, cfg.mamba)
    x, aux = _ffn(lp, cfg, ffn, x + o)
    return x, state, aux


def _final_norm(params: Mapping[str, torch.Tensor], name: str = "final_norm"
                ) -> Dict[str, torch.Tensor]:
    return {k.split(".", 1)[1]: v for k, v in params.items()
            if k.startswith(f"{name}.")}


# ---------------------------------------------------------------------------
# Training: the backbone, the chunked cross-entropy, the loss
# ---------------------------------------------------------------------------


def lm_backbone(params: Mapping[str, torch.Tensor], cfg: ModelConfig, emb: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward over ready embeddings (B, T, D): ``(hidden (B, T,
    D) in the compute dtype, moe_aux)``, JAX's ``lm_backbone`` on one device
    with ``remat="full"``. The weights are cast by ``_cast_tree``; each
    layer runs under ``checkpoint`` (non-reentrant), so the backward keeps
    only the layer boundaries and runs each layer's forward again, its
    attention kernel and its MoE routing included. ``moe_aux`` sums the
    layers' MoE terms in JAX's order (each repeat's sum added to the carry);
    a dense stack's is a zero f32 scalar, as in JAX."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = emb.to(cdt)
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device).expand(b, t)
    pattern, n_rep = _pattern_groups(cfg)
    p = _cast_tree(params, cdt)
    layers = [_layers(p, f"blocks.{pos}.") for pos in range(len(pattern))]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for rep in range(n_rep):
        rep_aux = None  # JAX's zero start: 0 + a is a
        for pos, (mixer, ffn) in enumerate(pattern):
            lp = layers[pos][rep]
            x, a = checkpoint(
                lambda x_, lp=lp, mixer=mixer, ffn=ffn: _block(
                    lp, cfg, mixer, ffn, x_, positions)[::2],  # x, aux
                x, use_reentrant=False)
            if a is not None:
                rep_aux = a if rep_aux is None else rep_aux + a
        if rep_aux is not None:
            aux = aux + rep_aux
    x = L.apply_norm(_final_norm(p), x, cfg.norm_eps)
    return x, aux


def vocab_parallel_xent(hidden: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                        *, t_chunk: int = 512, pad_id: int = -1) -> torch.Tensor:
    """Mean next-token cross-entropy over the non-pad labels, JAX's
    ``vocab_parallel_xent`` with no mesh (the whole vocabulary on one
    device). T is cut into chunks of ``t_chunk`` (the last padded with
    ``pad_id`` labels), so the f32 logits live a chunk at a time: ``(h_c @
    head_w)`` in the compute dtype, then f32; the max shift carries no
    gradient; the sums go chunk by chunk in order. hidden (B, T, D),
    head_w (D, V), labels (B, T) integers."""
    b, t, d = hidden.shape
    vs = head_w.shape[1]
    tc = min(t_chunk, t)
    n_chunks = -(-t // tc)
    pad = n_chunks * tc - t
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=pad_id)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        h_c, l_c = hidden[:, c * tc:(c + 1) * tc], labels[:, c * tc:(c + 1) * tc]
        logits = (h_c @ head_w).to(torch.float32)  # (B, tc, V)
        mx = logits.amax(-1).detach()
        lse = torch.log(torch.exp(logits - mx[..., None]).sum(-1)) + mx
        ok = (l_c >= 0) & (l_c < vs)
        picked = logits.gather(-1, l_c.clamp(0, vs - 1).long()[..., None])[..., 0]
        picked = torch.where(ok, picked, picked.new_zeros(()))
        valid = (l_c != pad_id).to(torch.float32)
        total = total + ((lse - picked) * valid).sum()
        count = count + valid.sum()
    return total / torch.clamp(count, min=1.0)


def make_lm_loss_fn(cfg: ModelConfig, *, t_chunk: int = 512) -> Callable:
    """``loss_fn(params, emb, mb) -> (total, {"xent", "moe_aux"})`` with
    ``mb = {"labels": (B, T)}``: the signature the FWP executor and the
    reference trainer take. ``head_w`` is cast to the compute dtype; the
    MoE term's coefficient is 0 for a dense stack."""
    cdt = getattr(torch, cfg.compute_dtype)
    aux_coef = cfg.moe.aux_loss_coef if cfg.moe is not None else 0.0

    def loss_fn(params, emb, mb):
        hidden, moe_aux = lm_backbone(params, cfg, emb)
        loss = vocab_parallel_xent(hidden, params["head_w"].to(cdt), mb["labels"],
                                   t_chunk=t_chunk)
        total = loss + aux_coef * moe_aux
        return total, {"xent": loss.detach(), "moe_aux": moe_aux.detach()}

    return loss_fn


# ---------------------------------------------------------------------------
# Serving: KV caches, prefill, decode
# ---------------------------------------------------------------------------


class LMCache(NamedTuple):
    """Per-pattern-position caches stacked over repeats (as params): an
    attention position's ``{"k", "v"}``, (n_rep, B, S, KV, hd); a Mamba
    position's ``{"conv", "ssm"}``, (n_rep, B, K-1, C) and (n_rep, B, H, P,
    N). ``length`` is the number of positions already filled. Decode writes
    the caches in place."""

    caches: Tuple[Dict[str, torch.Tensor], ...]
    length: int


def _empty_cache(cfg: ModelConfig, batch: int, max_len: int, kv_dtype: torch.dtype,
                 conv_dtype: torch.dtype, device) -> LMCache:
    pattern, n_rep = _pattern_groups(cfg)
    caches = []
    for mixer, _ in pattern:
        if mixer == "attn":
            a = cfg.attention
            shape = (n_rep, batch, max_len, a.n_kv_heads, a.head_dim)
            caches.append({"k": torch.zeros(shape, dtype=kv_dtype, device=device),
                           "v": torch.zeros(shape, dtype=kv_dtype, device=device)})
        else:
            conv, ssm = M.init_mamba_cache(batch, cfg.d_model, cfg.mamba, conv_dtype,
                                           device=device)
            caches.append({"conv": conv.expand(n_rep, *conv.shape).contiguous(),
                           "ssm": ssm.expand(n_rep, *ssm.shape).contiguous()})
    return LMCache(tuple(caches), 0)


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, *, device) -> LMCache:
    """Zero caches, as JAX's ``init_lm_cache``: k and v in ``dtype``, a Mamba
    position's conv and ssm states in f32 (a prefill's conv state is in the
    compute dtype: ``lm_prefill``)."""
    _check_ported(cfg)
    return _empty_cache(cfg, batch, max_len, dtype, torch.float32, device)


def lm_prefill(params: Mapping[str, torch.Tensor], cfg: ModelConfig, emb: torch.Tensor,
               *, cache_len=None) -> Tuple[torch.Tensor, LMCache]:
    """Run the backbone over the prompt embeddings (B, T, D) and build the
    cache of ``cache_len`` (default T) positions. Returns (last-token
    logits (B, V) in f32, cache). Each attention layer's k and v are
    computed once, by ``gqa_attention``, and feed both the attention and the
    cache (JAX computes them twice, to the same numbers); a Mamba layer
    caches the states it ends on, conv in the compute dtype and ssm in f32,
    JAX's prefill dtypes."""
    cdt = getattr(torch, cfg.compute_dtype)
    b, t, _ = emb.shape
    cache = _empty_cache(cfg, b, cache_len or t, cdt, cdt, emb.device)
    x = emb.to(cdt)
    positions = torch.arange(t, device=emb.device).expand(b, t)
    pattern, n_rep = _pattern_groups(cfg)
    p = _cast_tree(params, cdt)
    layers = [_layers(p, f"blocks.{pos}.") for pos in range(len(pattern))]
    for rep in range(n_rep):
        for pos, (mixer, ffn) in enumerate(pattern):
            x, state, _ = _block(layers[pos][rep], cfg, mixer, ffn, x, positions)
            c = cache.caches[pos]
            if mixer == "attn":
                c["k"][rep, :, :t] = state[0]
                c["v"][rep, :, :t] = state[1]
            else:
                c["conv"][rep] = state[0]
                c["ssm"][rep] = state[1]
    x = L.apply_norm(_final_norm(p), x, cfg.norm_eps)
    logits = (x[:, -1] @ p["head_w"].to(cdt)).to(torch.float32)
    return logits, cache._replace(length=t)


def lm_decode_step(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                   emb: torch.Tensor, cache: LMCache) -> Tuple[torch.Tensor, LMCache]:
    """One decode step for the new tokens' embeddings (B, 1, D) at position
    ``cache.length``. Returns (logits (B, V) in f32, the cache one longer;
    its tensors are the ones passed in, written in place: an attention
    layer's k and v at the new position, a Mamba layer's states by the
    ones ``mamba_decode_step`` returns). An MoE layer routes the B new
    tokens as one batch of B."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = emb.to(cdt)
    pattern, n_rep = _pattern_groups(cfg)
    p = _cast_tree(params, cdt)
    layers = [_layers(p, f"blocks.{pos}.") for pos in range(len(pattern))]
    for rep in range(n_rep):
        for pos, (mixer, ffn) in enumerate(pattern):
            lp = layers[pos][rep]
            c = cache.caches[pos]
            h = L.apply_norm(lp["norm1"], x, cfg.norm_eps)
            if mixer == "attn":
                o, _, _ = L.gqa_decode(lp["attn"], h, c["k"][rep], c["v"][rep],
                                       cache.length, cfg.attention)
            else:
                o, conv, ssm = M.mamba_decode_step(lp["mamba"], h, cfg.mamba,
                                                   c["conv"][rep], c["ssm"][rep])
                c["conv"][rep] = conv
                c["ssm"][rep] = ssm
            x, _ = _ffn(lp, cfg, ffn, x + o)
    x = L.apply_norm(_final_norm(p), x, cfg.norm_eps)
    logits = (x[:, 0] @ p["head_w"].to(cdt)).to(torch.float32)
    return logits, cache._replace(length=cache.length + 1)
