"""Dense-parameter optimizers (AdamW, SGD-momentum) and the constant LR
schedule, over dicts of tensors (``repro.train.optim`` in PyTorch).

The sparse (embedding) optimizer is rowwise Adagrad and lives in the
embedding engine, applied owner-side once per frozen window. ``update``
returns new params and a new state and writes neither the params nor the
grads. AdamW's moments are the exception: they are updated in place, as a
JAX step updates its donated state, so a step does not hold two copies of
them (for stablelm-3b, 21.3 GB each); the state passed in is consumed.
AdamW also updates a large leaf a block of rows at a time
(``ADAM_PIECE_ELEMS``), so its f32 temporaries are a block's, not the
leaf's: every op is elementwise, so the bits are the whole leaf's.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import OptimizerConfig

Params = Dict[str, torch.Tensor]
# the most elements of a leaf AdamW updates at once (256 MiB of f32 a
# temporary); a leaf is cut along its first axis
ADAM_PIECE_ELEMS = 1 << 26


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


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a true division (``float / tensor`` would multiply by a reciprocal),
    # by a tensor filled on the device: a tensor made from a Python float
    # is a copy from the host, which syncs the stream
    return torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-12), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: g * scale for k, g in grads.items()}, norm


def _row_blocks(p: torch.Tensor):
    """Slices of ``p``'s first axis, each at most ``ADAM_PIECE_ELEMS``
    elements (one row at least)."""
    rows = max(1, ADAM_PIECE_ELEMS // (p.numel() // p.shape[0]))
    return [slice(lo, lo + rows) for lo in range(0, p.shape[0], rows)]


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
        gnorm = global_norm(grads)
        # the clipped gradient, g * scale in g's dtype, is taken a block at
        # a time below
        scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 else None
        step = state.step + 1
        t = step.to(torch.float32)  # the bias corrections take t as f32
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        def piece(k, p, rows):
            """The new ``p[rows]`` in p's dtype; ``mu[k][rows]`` and
            ``nu[k][rows]`` updated in place."""
            g = grads[k][rows]
            g32 = (g if scale is None else g * scale).to(torch.float32)
            # b1 mu + (1 - b1) g and b2 nu + (1 - b2) g^2, each op rounded
            # as in the out-of-place form
            mu = state.mu[k][rows].mul_(b1).add_((1 - b1) * g32)
            nu = state.nu[k][rows].mul_(b2).add_((1 - b2) * torch.square(g32))
            del g, g32
            p32 = p[rows].to(torch.float32)
            delta = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p32
            return (p32 - lr * delta).to(p.dtype)

        new = {}
        for k, p in params.items():  # a leaf at a time, a large one by blocks
            if p.numel() <= ADAM_PIECE_ELEMS:
                new[k] = piece(k, p, ...)
                continue
            new[k] = torch.empty_like(p)
            for rows in _row_blocks(p):
                new[k][rows] = piece(k, p, rows)
        return new, AdamState(step, state.mu, state.nu), gnorm

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
