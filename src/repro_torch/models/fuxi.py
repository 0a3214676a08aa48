"""FuXi-alpha backbone (Ye et al., WWW 2025), the paper's second
generative-recommendation model (``repro.models.fuxi`` in PyTorch), and
its training loss.

FuXi layer (pre-norm):
    x = x + Attn(RMSNorm(x))                softmax GQA attention with RoPE
    h = RMSNorm(x);  v_0 = h W_up;  base = v_0
    v_{k+1} = v_k * sigmoid(base W_fi_k) + v_k     k = 0, 1, 2
    x = x + v_3 W_down

The attention runs through ``kernels.dispatch.flash_attention``: on the
card the 3xTF32 ``flash_attention`` forward kernel (FuXi's activations are
f32, its head dim 64) and the backward kernel, behind ``FlashAttention``;
the plain version on the CPU. JAX runs ``chunked_attention`` and differentiates it;
the function is the same.

The JAX layout is kept so weights carry across unchanged: ``x @ w``
throughout, the attention's ``wq``/``wk``/``wv``/``wo`` in (in, out)
layout. The forward is a pure function of a parameter dict named as the
module's state dict (``"layers.0.attn.wq"``, ...), as in ``models/hstu.py``.
"""
from __future__ import annotations

import functools
from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import AttentionConfig, RecsysModelConfig
from .dlrm import LossFn
from .hstu import sequence_infonce
from .layers import apply_norm, gqa_attention, init_attention, init_norm

FI_ORDERS = 3  # interaction orders in the MFFN block


def attention_config(cfg: RecsysModelConfig) -> AttentionConfig:
    """FuXi's attention: every head its own kv head, head dim d / H (JAX's
    ``_attn_cfg``, whose chunk sizes only the JAX package reads)."""
    return AttentionConfig(n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
                           head_dim=cfg.d_model // cfg.n_heads, impl="chunked",
                           q_chunk=256, kv_chunk=256)


def _params(tensors) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


def _normal(shape, std: float, *, device, generator) -> nn.Parameter:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.Parameter(w.normal_(0.0, std, generator=generator))


class FuXiLayer(nn.Module):
    def __init__(self, d: int, d_ff: int, acfg: AttentionConfig, *, device, generator):
        super().__init__()
        self.norm1 = _params(init_norm(d, "rmsnorm", device=device))
        self.attn = _params(init_attention(d, acfg, device=device, generator=generator))
        self.norm2 = _params(init_norm(d, "rmsnorm", device=device))
        self.w_up = _normal((d, d_ff), d ** -0.5, device=device, generator=generator)
        for o in range(FI_ORDERS):
            setattr(self, f"w_fi{o}", _normal((d_ff, d_ff), d_ff ** -0.5, device=device,
                                              generator=generator))
        self.w_down = _normal((d_ff, d), d_ff ** -0.5, device=device, generator=generator)


class FuXi(nn.Module):
    """The dense half of FuXi: ``in_proj`` (embedding dim -> d_model), the
    layers and the final RMSNorm. Weights are drawn from ``generator``."""

    def __init__(self, cfg: RecsysModelConfig, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        acfg = attention_config(cfg)
        self.layers = nn.ModuleList(
            FuXiLayer(cfg.d_model, cfg.d_ff, acfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))
        self.in_proj = _normal((cfg.max_table_dim, cfg.d_model), 0.02, device=device,
                               generator=generator)
        self.final_norm = _params(init_norm(cfg.d_model, "rmsnorm", device=device))

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return fuxi_forward(dict(self.named_parameters()), self.cfg, emb)


def _sub(params: Mapping[str, torch.Tensor], prefix: str):
    """The entries under ``prefix.`` with the prefix cut off."""
    cut = len(prefix) + 1
    return {k[cut:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def fuxi_layer(params: Mapping[str, torch.Tensor], prefix: str, x: torch.Tensor,
               acfg: AttentionConfig, eps: float) -> torch.Tensor:
    """One FuXi layer on ``x`` (B, S, d) with the weights under ``prefix``
    (``"layers.{i}"``); rope at positions ``0..S-1``."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    h = apply_norm(_sub(params, f"{prefix}.norm1"), x, eps)
    x = x + gqa_attention(_sub(params, f"{prefix}.attn"), h, acfg, positions=positions)[0]
    h = apply_norm(_sub(params, f"{prefix}.norm2"), x, eps)
    v = h @ params[f"{prefix}.w_up"]
    base = v
    for o in range(FI_ORDERS):  # multi-order Hadamard interactions
        v = v * torch.sigmoid(base @ params[f"{prefix}.w_fi{o}"]) + v
    return x + v @ params[f"{prefix}.w_down"]


def fuxi_forward(params: Mapping[str, torch.Tensor], cfg: RecsysModelConfig,
                 emb: torch.Tensor) -> torch.Tensor:
    """emb: (B, S, D_emb) item-embedding sequence -> hidden (B, S, d_model).

    A bf16 lookup is lifted to f32 before ``in_proj``, as JAX promotes
    ``bf16 @ f32``; its gradient comes back in bf16. Each layer is
    recomputed in the backward (``jax.checkpoint`` in JAX): only the
    layer-boundary activations are kept."""
    acfg = attention_config(cfg)
    x = emb.to(torch.float32) @ params["in_proj"]
    for i in range(cfg.n_layers):
        layer = functools.partial(fuxi_layer, params, f"layers.{i}", acfg=acfg,
                                  eps=cfg.norm_eps)
        x = checkpoint(layer, x, use_reentrant=False)
    return apply_norm(_sub(params, "final_norm"), x, cfg.norm_eps)


def make_fuxi_loss_fn(cfg: RecsysModelConfig, *,
                      temperature: float = 0.05) -> LossFn:
    """``loss_fn(params, emb, mb) -> (loss, {"hitrate_inseq": acc})``: the
    same in-sequence next-item InfoNCE as HSTU's (``sequence_infonce``),
    over FuXi's hidden states."""

    def loss_fn(params, emb, mb):
        hidden = fuxi_forward(params, cfg, emb)  # (B, S, d)
        preds = hidden[:, :-1]
        targets = emb[:, 1:].to(torch.float32) @ params["in_proj"]  # (B, S-1, d)
        loss, acc = sequence_infonce(preds, targets, temperature)
        return loss, {"hitrate_inseq": acc.detach()}

    return loss_fn
