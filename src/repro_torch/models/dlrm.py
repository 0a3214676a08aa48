"""DLRM-style CTR model: bottom MLP + embedding dot-interactions + top MLP
(``repro.models.dlrm`` in PyTorch).

The JAX layout is kept so weights carry across unchanged: each dense layer
holds ``w`` as (in, out) and applies ``x @ w + b``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..configs.base import RecsysModelConfig


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` (in, out), He-normal init, zero bias."""

    def __init__(self, d_in: int, d_out: int, *, device, generator):
        super().__init__()
        w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
        w.normal_(0.0, (2.0 / d_in) ** 0.5, generator=generator)
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = nn.Parameter(torch.zeros((d_out,), device=device),
                              requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def _mlp(dims: Sequence[int], *, device, generator) -> nn.ModuleList:
    return nn.ModuleList(
        Dense(dims[i], dims[i + 1], device=device, generator=generator)
        for i in range(len(dims) - 1))


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor,
               final_act: bool = False) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def num_feature_slots(cfg: RecsysModelConfig) -> int:
    return sum(t.bag_size for t in cfg.tables)


class DLRM(nn.Module):
    """Dense half of DLRM: ``bottom`` (dense features -> D) and ``top``
    (interactions -> one logit). Inference only: no parameter takes grads."""

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
        return dlrm_forward(self, self.cfg, emb, dense)


def pool_tables(cfg: RecsysModelConfig, emb: torch.Tensor) -> torch.Tensor:
    """(B, F_total, D) position embeddings -> (B, n_tables, D) bag-pooled."""
    outs = []
    off = 0
    for t in cfg.tables:
        seg = emb[:, off: off + t.bag_size]
        outs.append(seg.sum(1) if t.combiner == "sum" else seg.mean(1))
        off += t.bag_size
    return torch.stack(outs, dim=1)


def dlrm_forward(model: DLRM, cfg: RecsysModelConfig, emb: torch.Tensor,
                 dense: torch.Tensor) -> torch.Tensor:
    """emb: (B, F_total, D); dense: (B, num_dense). Returns logits (B,)."""
    pooled = pool_tables(cfg, emb)  # (B, F, D)
    bottom = _mlp_apply(model.bottom, dense, final_act=True)  # (B, D)
    allv = torch.cat([pooled, bottom[:, None, :]], dim=1)  # (B, F+1, D)
    inter = torch.bmm(allv, allv.transpose(1, 2))
    f = allv.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=allv.device)
    flat_inter = inter[:, iu, ju]  # (B, F(F+1)/2 pairs), row-major order
    top_in = torch.cat([bottom, flat_inter, dense], dim=-1)
    return _mlp_apply(model.top, top_in)[:, 0]
