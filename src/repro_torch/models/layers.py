"""Shared neural layers (``repro.models.layers``): norms, RoPE, MLPs
(swiglu / relu² / gelu) and GQA attention, pure functions over parameter
dicts (``{"scale"}`` for RMSNorm, ``{"scale", "bias"}`` for LayerNorm,
``wq``/``wk``/``wv``/``wo`` and ``wi``/``wg``/``wo`` in (in, out) layout).
Full-sequence attention runs ``kernels.dispatch.flash_attention``, forward
and backward; decode attention is plain PyTorch, as in JAX. The MoE FFN
(``router``, and ``wi``/``wg``/``wo`` stacked over experts) routes top-k
and computes the experts in capacity slots (``apply_moe_slotted``), with
tensor ops: JAX's MoE reaches no Pallas kernel."""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..configs.base import AttentionConfig, MoEConfig
from ..kernels import dispatch, ref
from ..utils import round_up


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


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def init_moe(d: int, f: int, cfg: MoEConfig, mlp_type: str, *, dtype=torch.float32,
             device=None, generator=None, lead: Tuple[int, ...] = ()
             ) -> Dict[str, torch.Tensor]:
    """``router`` (d, E) in f32 whatever ``dtype`` (as in JAX), the experts'
    ``wi`` (E, d, f), ``wo`` (E, f, d) and, for swiglu, ``wg`` (E, d, f) in
    ``dtype``, each behind ``lead`` stacking axes."""
    kw = dict(device=device, generator=generator)
    e = cfg.num_experts
    p = {"router": _normal((*lead, d, e), d ** -0.5, dtype=torch.float32, **kw),
         "wi": _normal((*lead, e, d, f), d ** -0.5, dtype=dtype, **kw),
         "wo": _normal((*lead, e, f, d), f ** -0.5, dtype=dtype, **kw)}
    if mlp_type == "swiglu":
        p["wg"] = _normal((*lead, e, d, f), d ** -0.5, dtype=dtype, **kw)
    return p


def _router_logits(params: Mapping[str, torch.Tensor], xt: torch.Tensor) -> torch.Tensor:
    """(n, E) f32 logits. ``_cast_tree`` casts the stacked router to the
    compute dtype, and JAX's ``f32 @ bf16`` then promotes it to f32; torch
    refuses mixed types, so the router is lifted here (exactly)."""
    return xt.to(torch.float32) @ params["router"].to(torch.float32)


def _topk_routing(logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, E) -> (n, k) expert ids, largest logit first, and their combine
    weights (the softmax over the k logits, in f32)."""
    gates, ids = torch.topk(logits, top_k, dim=-1)
    return ids, torch.softmax(gates.to(torch.float32), dim=-1)


def moe_aux_loss(logits: torch.Tensor, ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum(frac_tokens * frac_prob),
    the token share by each token's top-1 expert."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    frac_prob = probs.mean(0)
    # the top-1 counts as sums of ones: exact in any order (no host sync, as
    # one_hot's range check would make)
    top1 = ids[:, 0]
    counts = torch.zeros(num_experts, dtype=torch.float32, device=ids.device).scatter_add_(
        0, top1, torch.ones(top1.shape, dtype=torch.float32, device=ids.device))
    frac_tok = counts / top1.shape[0]
    return num_experts * torch.sum(frac_prob * frac_tok)


def moe_capacity(n: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``n`` tokens: JAX's Python float arithmetic,
    rounded up to a multiple of 8."""
    return round_up(max(8, int(n * cfg.top_k / cfg.num_experts * cfg.capacity_factor)), 8)


class MoESlots(NamedTuple):
    """Where each of a token's k picks sits among the (E * cap) slots.
    ``pick_slot`` (n, k): a token's slots in ascending expert order, -1 for
    a pick dropped over capacity; ``pick_w`` (n, k): their combine weights
    (f32) in the same order; ``slot_pick`` (E * cap,): the flat index
    ``token * k + j`` into ``pick_slot`` of the pick that fills each slot,
    -1 for an empty one. The two index maps are each other's inverse."""

    pick_slot: torch.Tensor
    pick_w: torch.Tensor
    slot_pick: torch.Tensor


def moe_slots(ids: torch.Tensor, w: torch.Tensor, num_experts: int, cap: int) -> MoESlots:
    """JAX's slotted dispatch plan: the picks sorted by expert, stably (a
    token earlier in the batch ranks first within an expert), the first
    ``cap`` of each expert kept. Integer work with no host sync: the
    dropped picks' writes go to a spare last slot that is cut off."""
    n, k = ids.shape
    e = num_experts
    ids_s, by_expert = torch.sort(ids, dim=1, stable=True)  # a token's picks
    pick_w = w.gather(1, by_expert)
    flat = ids_s.reshape(-1)
    se, order = torch.sort(flat, stable=True)
    starts = torch.searchsorted(se, torch.arange(e, device=ids.device, dtype=se.dtype))
    rank = torch.arange(n * k, device=ids.device) - starts[se]
    slot = torch.where(rank < cap, se * cap + rank, torch.full_like(rank, e * cap))
    spare = torch.full((e * cap + 1,), -1, dtype=torch.int64, device=ids.device)
    slot_pick = spare.index_put_((slot,), order)[:-1]
    pick_slot = torch.empty_like(slot).scatter_(0, order, slot)
    pick_slot = torch.where(pick_slot < e * cap, pick_slot, -1).reshape(n, k)
    return MoESlots(pick_slot, pick_w, slot_pick)


def _rows_or_zero(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` over rows, a zero row where ``idx < 0``: shape
    (*idx.shape, src.shape[-1])."""
    out = src.index_select(0, idx.reshape(-1).clamp(min=0))
    out.masked_fill_((idx.reshape(-1) < 0)[:, None], 0)
    return out.reshape(*idx.shape, src.shape[-1])


class _GatherRows(torch.autograd.Function):
    """``out = _rows_or_zero(src, idx)`` with a backward that gathers too:
    ``grad_src[r] = sum_j grad_out[inv[r, j]]`` (a zero term where ``inv < 0``),
    summed over ``j`` in order. ``inv`` lists, for each row of ``src``, the
    output rows that read it: the inverse of ``idx``. Where torch's own
    backward of a gather scatters with atomics (bits that change from run
    to run on the card), this one sums in a fixed order."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _rows_or_zero(src, idx)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        parts = _rows_or_zero(grad.reshape(-1, grad.shape[-1]), inv).unbind(1)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total, None, None


def _experts(params: Mapping[str, torch.Tensor], xe: torch.Tensor, mlp_type: str,
             activation: str) -> torch.Tensor:
    """Every expert's MLP on its own slots: xe (E, cap, d) -> (E, cap, d)."""
    act = activation_fn(activation)
    h = torch.bmm(xe, params["wi"])
    if mlp_type == "swiglu":
        h = act(torch.bmm(xe, params["wg"])) * h
    else:
        h = act(h)
    return torch.bmm(h, params["wo"])


def _dispatch(xt: torch.Tensor, slots: MoESlots) -> torch.Tensor:
    """xt (n, d) into the experts' slots: (E * cap, d), a zero row where a
    slot is empty. Its backward sums a token's picks by ``pick_slot``."""
    k = slots.pick_slot.shape[1]
    slot_tok = torch.where(slots.slot_pick >= 0, slots.slot_pick // k, -1)
    return _GatherRows.apply(xt, slot_tok, slots.pick_slot)


def _combine(ye: torch.Tensor, slots: MoESlots) -> torch.Tensor:
    """The experts' slot outputs ye (E * cap, d) back to their tokens: (n,
    d) in ye's dtype, each token's picks weighted (the weights cast to ye's
    dtype first, as in JAX) and summed in ascending expert order, the
    order of JAX's scatter-add of the stably sorted updates; a dropped pick
    adds a zero row."""
    picked = _GatherRows.apply(ye, slots.pick_slot, slots.slot_pick[:, None])
    contrib = (picked * slots.pick_w[..., None].to(ye.dtype)).unbind(1)
    out = contrib[0]
    for c in contrib[1:]:
        out = out + c
    return out


def apply_moe_slotted(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
                      mlp_type: str, activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-slotted MoE of x (B, T, d): ``(out in x's dtype, aux)``.

    Each token's top-k picks are ranked within their expert and placed
    into (E, cap) slots (``moe_slots``); picks past an expert's capacity
    are dropped (Switch semantics). The dispatch and the combine
    (``_dispatch``, ``_combine``) are gathers by the slot maps
    (``_GatherRows``), each with the other's map for its backward: no
    scatter, no atomics, in either direction."""
    b, t, d = x.shape
    xt = x.reshape(-1, d)
    n = xt.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    cap = moe_capacity(n, cfg)
    logits = _router_logits(params, xt)
    ids, w = _topk_routing(logits, k)
    slots = moe_slots(ids, w, e, cap)
    xe = _dispatch(xt, slots).reshape(e, cap, d)
    out = _combine(_experts(params, xe, mlp_type, activation).reshape(e * cap, d), slots)
    aux = moe_aux_loss(logits, ids, e)
    return out.reshape(b, t, d).to(x.dtype), aux


def apply_moe_dense(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
                    mlp_type: str, activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-dense MoE: every expert computes every token, combined by the
    top-k weights (E / k times the work of the slotted form). JAX takes it
    when the experts do not divide the expert shards; on one device
    ``apply_moe`` never does. Kept for parity."""
    b, t, d = x.shape
    xt = x.reshape(-1, d)
    logits = _router_logits(params, xt)
    ids, w = _topk_routing(logits, cfg.top_k)
    act = activation_fn(activation)
    h = torch.einsum("td,edf->etf", xt, params["wi"])
    if mlp_type == "swiglu":
        h = act(torch.einsum("td,edf->etf", xt, params["wg"])) * h
    else:
        h = act(h)
    y = torch.einsum("etf,efd->etd", h, params["wo"])
    combine = torch.zeros((xt.shape[0], cfg.num_experts), dtype=torch.float32,
                          device=x.device).scatter(1, ids, w)
    out = torch.einsum("te,etd->td", combine.to(y.dtype), y)
    aux = moe_aux_loss(logits, ids, cfg.num_experts)
    return out.reshape(b, t, d), aux


def apply_moe(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
              mlp_type: str, activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``apply_moe`` on one device (``num_expert_shards=1``): the
    slotted form. The expert-parallel ``shard_map`` form is multi-rank."""
    return apply_moe_slotted(params, x, cfg, mlp_type, activation)
