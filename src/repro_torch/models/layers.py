"""Shared neural layers (``repro.models.layers``): norms, RoPE, MLPs
(swiglu / relu² / gelu) and GQA attention, pure functions over parameter
dicts (``{"scale"}`` for RMSNorm, ``{"scale", "bias"}`` for LayerNorm,
``wq``/``wk``/``wv``/``wo`` and ``wi``/``wg``/``wo`` in (in, out) layout).
Full-sequence attention runs ``kernels.dispatch.flash_attention``, forward
and backward; decode attention is plain PyTorch, as in JAX. MoE is not
ported."""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..configs.base import AttentionConfig
from ..kernels import dispatch, ref


def init_norm(d: int, norm_type: str = "rmsnorm", *,
              device=None) -> Dict[str, torch.Tensor]:
    if norm_type == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def apply_norm(params: Mapping[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm when ``params`` has a bias, else RMSNorm; computed in f32
    (LayerNorm with the biased variance, as ``jnp.var``) and returned in
    ``x``'s dtype."""
    xf = x.to(torch.float32)
    if "bias" in params:
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * params["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: (..., T) integers. Rotates the two
    halves of hd in f32 and returns x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------


def activation_fn(name: str):
    if name == "silu":
        return torch.nn.functional.silu
    if name == "gelu":  # jax.nn.gelu's default is the tanh approximation
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu2":  # squared ReLU (nemotron-4)
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(name)


def _normal(shape, scale: float, *, dtype, device, generator) -> torch.Tensor:
    """Normal(0, 1) * scale drawn in place in ``dtype`` (no f32 temporary)."""
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(generator=generator).mul_(scale)


def init_mlp(d: int, f: int, mlp_type: str, *, dtype=torch.float32, device=None,
             generator=None, lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """``wi`` (d, f), ``wo`` (f, d) and, for swiglu, ``wg`` (d, f), each
    behind ``lead`` stacking axes (one per layer)."""
    kw = dict(dtype=dtype, device=device, generator=generator)
    p = {"wi": _normal((*lead, d, f), d ** -0.5, **kw),
         "wo": _normal((*lead, f, d), f ** -0.5, **kw)}
    if mlp_type == "swiglu":
        p["wg"] = _normal((*lead, d, f), d ** -0.5, **kw)
    return p


def apply_mlp(params: Mapping[str, torch.Tensor], x: torch.Tensor, mlp_type: str,
              activation: str) -> torch.Tensor:
    act = activation_fn(activation)
    h = x @ params["wi"]
    if mlp_type == "swiglu":
        h = act(x @ params["wg"]) * h
    else:
        h = act(h)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Attention (GQA + RoPE)
# ---------------------------------------------------------------------------


def init_attention(d: int, cfg: AttentionConfig, *, dtype=torch.float32, device=None,
                   generator=None, lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    kw = dict(dtype=dtype, device=device, generator=generator)
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {"wq": _normal((*lead, d, hq), d ** -0.5, **kw),
            "wk": _normal((*lead, d, hkv), d ** -0.5, **kw),
            "wv": _normal((*lead, d, hkv), d ** -0.5, **kw),
            "wo": _normal((*lead, hq, d), hq ** -0.5, **kw)}


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, KV*groups, hd) by group repetition."""
    return ref.repeat_kv(k, k.shape[2] * groups)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    q_offset: int = 0, kv_len=None) -> torch.Tensor:
    """Materialized-scores attention. q: (B, Tq, H, hd); k, v: (B, Tk, KV,
    hd) with H % KV == 0 (each kv head serves its group of query heads in
    place, without ``_repeat_kv``'s copy). Scores in q's dtype lifted to
    f32, -1e30 where masked (causal, and keys at or past ``kv_len``), f32
    softmax cast to q's dtype before the product with v."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, tq, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32) * (1.0 / hd ** 0.5)
    q_pos = torch.arange(tq, device=q.device) + q_offset
    k_pos = torch.arange(tk, device=q.device)
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if kv_len is not None:
        mask &= k_pos[None, :] < kv_len
    scores = torch.where(mask, scores, scores.new_full((), -1e30))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v).reshape(b, tq, h, hd)


def _qkv(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: AttentionConfig,
         positions: torch.Tensor):
    """The projections of x (B, T, D), q and k rotated at ``positions``:
    q (B, T, H, hd), k and v (B, T, KV, hd)."""
    b, t, _ = x.shape
    q = (x @ params["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def gqa_attention(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cfg: AttentionConfig, *, positions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence GQA attention of x (B, T, D): an LM prefill, or a FuXi
    layer in training. Returns ``(out, k, v)``: the output and the rotated
    k and v (B, T, KV, hd) that a prefill keeps in its cache. JAX's
    ``cfg.impl`` ("naive" | "chunked" | "pallas") picks one of three ways
    to the same function, and JAX differentiates it; the port has one,
    ``dispatch.flash_attention``: on the card the CUDA forward kernel, which
    reads the kv heads in place, and under autograd the backward kernel
    too; the plain version on the CPU."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device).expand(b, t)
    q, k, v = _qkv(params, x, cfg, positions)
    o = dispatch.flash_attention(q, k, v, causal=cfg.causal)
    return o.reshape(b, t, -1) @ params["wo"], k, v


def gqa_decode(params: Mapping[str, torch.Tensor], x: torch.Tensor,
               cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
               cfg: AttentionConfig):
    """Single-token decode of x (B, 1, D) at position ``pos`` against caches
    (B, S, KV, hd). Writes the new k and v into the caches IN PLACE (JAX
    returns updated copies) and returns ``(out, cache_k, cache_v)``. Plain
    PyTorch, as in JAX: no kernel runs here."""
    b = x.shape[0]
    if not 0 <= pos < cache_k.shape[1]:
        raise ValueError(f"decode position {pos} is outside the cache of "
                         f"{cache_k.shape[1]} positions")
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    o = naive_attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype), causal=False,
                        kv_len=pos + 1)
    return o.reshape(b, 1, -1) @ params["wo"], cache_k, cache_v
