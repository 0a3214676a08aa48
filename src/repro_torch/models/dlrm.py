"""DLRM-style CTR model: bottom MLP + embedding dot-interactions + top MLP
(``repro.models.dlrm`` in PyTorch), and its training loss.

The JAX layout is kept so weights carry across unchanged: each dense layer
holds ``w`` as (in, out) and applies ``x @ w + b``. The forward is a pure
function of a parameter dict (``dlrm_forward``) named as the module's
state dict (``"bottom.0.w"``, ...): the trainer keeps those tensors in its
state and differentiates them; the module holds the weights a serving
path reads, under ``torch.inference_mode``.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence, Tuple

import torch
from torch import nn

from ..configs.base import RecsysModelConfig


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` (in, out), He-normal init, zero bias."""

    def __init__(self, d_in: int, d_out: int, *, device, generator):
        super().__init__()
        w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
        w.normal_(0.0, (2.0 / d_in) ** 0.5, generator=generator)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros((d_out,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def _mlp(dims: Sequence[int], *, device, generator) -> nn.ModuleList:
    return nn.ModuleList(
        Dense(dims[i], dims[i + 1], device=device, generator=generator)
        for i in range(len(dims) - 1))


def _mlp_apply(params: Mapping[str, torch.Tensor], prefix: str, n_layers: int,
               x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ params[f"{prefix}.{i}.w"] + params[f"{prefix}.{i}.b"]
        if i < n_layers - 1 or final_act:
            x = torch.relu(x)
    return x


def num_feature_slots(cfg: RecsysModelConfig) -> int:
    return sum(t.bag_size for t in cfg.tables)


class DLRM(nn.Module):
    """Dense half of DLRM: ``bottom`` (dense features -> D) and ``top``
    (interactions -> one logit)."""

    def __init__(self, cfg: RecsysModelConfig, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.max_table_dim
        f = len(cfg.tables)  # pooled feature vectors (one per table)
        n_inter = f * (f - 1) // 2 + f  # pairwise dots + self
        top_in = d + n_inter + cfg.num_dense_features
        self.bottom = _mlp((cfg.num_dense_features, cfg.d_ff, d),
                           device=device, generator=generator)
        self.top = _mlp((top_in, cfg.d_ff, cfg.d_ff // 2, 1),
                        device=device, generator=generator)

    def forward(self, emb: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        return dlrm_forward(dict(self.named_parameters()), self.cfg, emb, dense)


def pool_tables(cfg: RecsysModelConfig, emb: torch.Tensor) -> torch.Tensor:
    """(B, F_total, D) position embeddings -> (B, n_tables, D) bag-pooled.

    One ``split`` instead of a slice per table: a slice's backward writes
    a zero-filled full-size gradient per table and adds them up; the
    split's backward concatenates once. The values are the same."""
    segs = torch.split(emb, [t.bag_size for t in cfg.tables], dim=1)
    return torch.stack([seg.sum(1) if t.combiner == "sum" else seg.mean(1)
                        for t, seg in zip(cfg.tables, segs)], dim=1)


def dlrm_forward(params: Mapping[str, torch.Tensor], cfg: RecsysModelConfig,
                 emb: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """emb: (B, F_total, D); dense: (B, num_dense). Returns logits (B,)."""
    pooled = pool_tables(cfg, emb)  # (B, F, D)
    bottom = _mlp_apply(params, "bottom", 2, dense, final_act=True)  # (B, D)
    allv = torch.cat([pooled, bottom[:, None, :]], dim=1)  # (B, F+1, D)
    inter = torch.bmm(allv, allv.transpose(1, 2))
    f = allv.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=allv.device)
    flat_inter = inter[:, iu, ju]  # (B, F(F+1)/2 pairs), row-major order
    top_in = torch.cat([bottom, flat_inter, dense], dim=-1)
    return _mlp_apply(params, "top", 3, top_in)[:, 0]


LossFn = Callable[[Mapping[str, torch.Tensor], torch.Tensor,
                   Mapping[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_dlrm_loss_fn(cfg: RecsysModelConfig) -> LossFn:
    """``loss_fn(params, emb, mb) -> (loss, {"acc": acc})``: mean binary
    cross-entropy on the logits, in JAX's written-out stable form."""

    def loss_fn(params, emb, mb):
        logit = dlrm_forward(params, cfg, emb, mb["dense"])
        y = mb["labels"]
        loss = torch.mean(torch.clamp(logit, min=0) - logit * y
                          + torch.log1p(torch.exp(-torch.abs(logit))))
        acc = torch.mean(((logit > 0) == (y > 0.5)).to(torch.float32))
        return loss, {"acc": acc.detach()}

    return loss_fn
