"""HSTU backbone (Zhai et al., ICML 2024, "Actions Speak Louder than
Words"), the paper's primary generative-recommendation model
(``repro.models.hstu`` in PyTorch), and its training loss.

HSTU layer (pointwise aggregated attention):
    [U, V, Q, K] = split(silu(X W_uvqk))       per head, in that order
    A = silu(Q K^T / sqrt(d)) * causal_mask / seq_len   (no softmax)
    Y = A V
    out = (layernorm(Y) * U) W_o + X

The attention runs through ``kernels.dispatch.hstu_attention``: the CUDA
forward and backward kernels on the card, the plain version on the CPU.
JAX computes it inline in jnp, in query chunks; the function is the same.

The JAX layout is kept so weights carry across unchanged: ``w_uvqk`` is
``(d, h * (2 dqk + 2 dv))`` with each head's ``[u | v | q | k]`` columns
side by side, ``w_o`` is ``(h * dv, d)``, and ``x @ w`` throughout. The
forward is a pure function of a parameter dict named as the module's state
dict (``"layers.0.w_uvqk"``, ...), as in ``models/dlrm.py``.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import RecsysModelConfig
from ..kernels import dispatch
from .dlrm import LossFn
from .layers import apply_norm, init_norm


def _layernorm(d: int, *, device) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in
                             init_norm(d, "layernorm", device=device).items()})


def _normal(shape, std: float, *, device, generator) -> nn.Parameter:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.Parameter(w.normal_(0.0, std, generator=generator))


class HSTULayer(nn.Module):
    def __init__(self, d: int, h: int, dqk: int, dv: int, *, device, generator):
        super().__init__()
        self.norm = _layernorm(d, device=device)
        self.w_uvqk = _normal((d, h * (2 * dqk + 2 * dv)), d ** -0.5,
                              device=device, generator=generator)
        self.w_o = _normal((h * dv, d), (h * dv) ** -0.5, device=device,
                           generator=generator)
        self.out_norm = _layernorm(h * dv, device=device)


class HSTU(nn.Module):
    """The dense half of HSTU: ``in_proj`` (embedding dim -> d_model), the
    layers and the final norm. Weights are drawn from ``generator``."""

    def __init__(self, cfg: RecsysModelConfig, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        self.layers = nn.ModuleList(
            HSTULayer(d, h, d // h, d // h, device=device, generator=generator)
            for _ in range(cfg.n_layers))
        self.in_proj = _normal((cfg.max_table_dim, d), 0.02, device=device,
                               generator=generator)
        self.final_norm = _layernorm(d, device=device)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return hstu_forward(dict(self.named_parameters()), self.cfg, emb)


def _norm(params: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {"scale": params[f"{prefix}.scale"], "bias": params[f"{prefix}.bias"]}


def hstu_layer(params: Mapping[str, torch.Tensor], prefix: str, x: torch.Tensor,
               h: int, dqk: int, dv: int, eps: float) -> torch.Tensor:
    """One HSTU layer on ``x`` (B, S, d) with the weights under ``prefix``
    (``"layers.{i}"``)."""
    b, s, _ = x.shape
    n = apply_norm(_norm(params, f"{prefix}.norm"), x, eps)
    mixed = torch.nn.functional.silu(n @ params[f"{prefix}.w_uvqk"])
    # q, k, v stay strided views of ``mixed``: the kernel reads the strides
    u, v, q, k = torch.split(mixed.reshape(b, s, h, 2 * dqk + 2 * dv),
                             [dv, dv, dqk, dqk], dim=-1)
    y = dispatch.hstu_attention(q, k, v, causal=True).reshape(b, s, h * dv)
    y = apply_norm(_norm(params, f"{prefix}.out_norm"), y, eps) * u.reshape(b, s, h * dv)
    return x + y @ params[f"{prefix}.w_o"]


def hstu_forward(params: Mapping[str, torch.Tensor], cfg: RecsysModelConfig,
                 emb: torch.Tensor) -> torch.Tensor:
    """emb: (B, S, D_emb) item-embedding sequence -> hidden (B, S, d_model).

    A bf16 lookup is lifted to f32 before ``in_proj``, as JAX promotes
    ``bf16 @ f32``; its gradient comes back in bf16. Each layer is
    recomputed in the backward (``jax.checkpoint`` in JAX): only the
    layer-boundary activations are kept."""
    d, h = cfg.d_model, cfg.n_heads
    x = emb.to(torch.float32) @ params["in_proj"]
    for i in range(cfg.n_layers):
        layer = functools.partial(hstu_layer, params, f"layers.{i}", h=h,
                                  dqk=d // h, dv=d // h, eps=cfg.norm_eps)
        x = checkpoint(layer, x, use_reentrant=False)
    return apply_norm(_norm(params, "final_norm"), x, cfg.norm_eps)


def sequence_infonce(preds: torch.Tensor, targets: torch.Tensor,
                     temperature: float = 0.05):
    """Per-sequence sampled softmax: position t's prediction scored against
    all target items of the same sequence (positives on the diagonal).
    Returns ``(loss, accuracy)``."""
    pf = preds / (torch.linalg.vector_norm(preds, dim=-1, keepdim=True) + 1e-6)
    tf = targets / (torch.linalg.vector_norm(targets, dim=-1, keepdim=True) + 1e-6)
    logits = torch.einsum("bqd,bkd->bqk", pf, tf) / temperature  # (B, S-1, S-1)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    loss = -torch.diagonal(logp, dim1=1, dim2=2).mean()
    diag = torch.arange(logits.shape[1], device=logits.device)
    acc = (logits.argmax(-1) == diag[None]).to(torch.float32).mean()
    return loss, acc


def make_hstu_loss_fn(cfg: RecsysModelConfig, *,
                      temperature: float = 0.05) -> LossFn:
    """``loss_fn(params, emb, mb) -> (loss, {"hitrate_inseq": acc})``:
    next-item InfoNCE over each sequence's own item embeddings. Position
    t's hidden predicts the embedding of item t+1 against in-sequence
    negatives, so the embeddings get gradients twice, from the input side
    and from the target side."""

    def loss_fn(params, emb, mb):
        hidden = hstu_forward(params, cfg, emb)  # (B, S, d)
        preds = hidden[:, :-1]
        targets = emb[:, 1:].to(torch.float32) @ params["in_proj"]  # (B, S-1, d)
        loss, acc = sequence_infonce(preds, targets, temperature)
        return loss, {"hitrate_inseq": acc.detach()}

    return loss_fn
