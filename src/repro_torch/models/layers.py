"""Shared neural layers (``repro.models.layers``, the norms only): pure
functions over parameter dicts, ``{"scale"}`` for RMSNorm and
``{"scale", "bias"}`` for LayerNorm."""
from __future__ import annotations

from typing import Dict, Mapping

import torch


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
