"""Dense-parameter optimizers (AdamW, SGD-momentum) and the constant LR
schedule, over dicts of tensors (``repro.train.optim`` in PyTorch).

The sparse (embedding) optimizer is rowwise Adagrad and lives in the
embedding engine, applied owner-side once per frozen window. Updates are
functional, like JAX's: ``update`` returns new params and a new state and
writes no input.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import OptimizerConfig

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Params  # first moment (f32)
    nu: Params  # second moment (f32)


class SgdState(NamedTuple):
    step: torch.Tensor
    mom: Params


class OptimizerPair(NamedTuple):
    """init/update closure pair for a dense optimizer."""

    init: Callable[[Params], object]
    update: Callable[[Params, object, Params, torch.Tensor],
                     Tuple[Params, object, torch.Tensor]]


def global_norm(tree: Params) -> torch.Tensor:
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    # a true division (``float / tensor`` would multiply by a reciprocal),
    # by a tensor filled on the device: a tensor made from a Python float
    # is a copy from the host, which syncs the stream
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _step0(params: Params) -> torch.Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def make_adamw(cfg: OptimizerConfig) -> OptimizerPair:
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay

    def init(params: Params) -> AdamState:
        return AdamState(_step0(params), _zeros_like(params), _zeros_like(params))

    def update(params: Params, state: AdamState, grads: Params, lr):
        if cfg.grad_clip > 0:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        else:
            gnorm = global_norm(grads)
        step = state.step + 1
        t = step.to(torch.float32)  # the bias corrections take t as f32
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        mu = {k: b1 * state.mu[k] + (1 - b1) * grads[k].to(torch.float32)
              for k in params}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(grads[k].to(torch.float32))
              for k in params}
        new = {}
        for k, p in params.items():
            p32 = p.to(torch.float32)
            delta = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) + wd * p32
            new[k] = (p32 - lr * delta).to(p.dtype)
        return new, AdamState(step, mu, nu), gnorm

    return OptimizerPair(init, update)


def make_sgd(cfg: OptimizerConfig, momentum: float = 0.9) -> OptimizerPair:
    def init(params: Params) -> SgdState:
        return SgdState(_step0(params), _zeros_like(params))

    def update(params: Params, state: SgdState, grads: Params, lr):
        if cfg.grad_clip > 0:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        else:
            gnorm = global_norm(grads)
        mom = {k: momentum * state.mom[k] + grads[k].to(torch.float32)
               for k in params}
        new = {k: (p.to(torch.float32) - lr * mom[k]).to(p.dtype)
               for k, p in params.items()}
        return new, SgdState(state.step + 1, mom), gnorm

    return OptimizerPair(init, update)


def make_optimizer(cfg: OptimizerConfig) -> OptimizerPair:
    if cfg.name == "adamw":
        return make_adamw(cfg)
    if cfg.name == "sgd":
        return make_sgd(cfg)
    raise ValueError(f"unknown optimizer {cfg.name}")


def constant_lr(lr: float, device: Optional[torch.device | str] = None):
    """``step -> lr`` as an f32 scalar tensor on ``device``."""
    value = torch.full((), lr, dtype=torch.float32, device=device)
    return lambda step: value
