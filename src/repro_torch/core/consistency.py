"""Reference synchronous trainer, the gold standard for Definition 1
(``repro.core.consistency`` in PyTorch).

A deliberately naive implementation of Eq. (1): a plain table gather (no
routing, no buffers, no exchange), full-batch gradients by scatter-add
into a dense (Vp, D) gradient, each key's rows added in input order on
every device (``add_rows_in_order``), one rowwise-adagrad update per step.
NestPipe's DBP + FWP pipeline and the serial baseline must reproduce this
trajectory; the async mode must not. It allocates a (Vp, D) gradient and
a second table, so it runs at small sizes only.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.fwp.executor import value_and_grad
from ..train.optim import OptimizerPair
from ..train.state import TrainState
from .embedding.table import EmbeddingTableState


def add_rows_in_order(grad: torch.Tensor, keys: torch.Tensor, rows: torch.Tensor) -> None:
    """``grad[keys[i]] += rows[i]`` in place, for i in input order: each
    key's rows are added one at a time, in the order they come, as
    ``index_add_`` adds on the CPU (the same bits there). On CUDA
    ``index_add_`` adds with atomics in no fixed order, so its bits change
    from run to run. Here a stable sort ranks each key's positions, and
    pass ``j`` adds every key's ``j``-th row: within a pass the keys are
    distinct, so each element sees one plain add in a fixed order on every
    device."""
    order = torch.sort(keys, stable=True).indices
    keys, rows = keys[order], rows[order]
    first = torch.searchsorted(keys, keys)  # where each key's run starts
    rank = torch.arange(keys.numel(), device=keys.device) - first
    for j in range(int(rank.max()) + 1 if keys.numel() else 0):
        at = rank == j
        grad[keys[at]] += rows[at]


def build_reference_step(
    loss_fn: Callable,  # (dense_params, emb, mb_batch) -> (loss, metrics)
    optimizer: OptimizerPair,
    lr_sched: Callable,
    n_micro: int,
    *,
    sparse_lr: float = 0.05,
    sparse_eps: float = 1e-8,
):
    """Returns ``step(state, batch)`` where ``batch`` holds stacked (N, ...)
    fields and ``keys`` holds scrambled mega-table ids. No engine
    machinery whatsoever."""

    def step(state: TrainState, batch):
        rows = state.table.rows
        vp, d = rows.shape
        table_grad = torch.zeros((vp, d), dtype=torch.float32, device=rows.device)
        gsum = None
        losses = []
        for i in range(n_micro):
            mb = {k: v[i] for k, v in batch.items()}
            keys = mb["keys"].long()
            emb = rows[keys].to(torch.float32)
            (loss, _), (dg, demb) = value_and_grad(loss_fn, state.dense, emb, mb)
            add_rows_in_order(table_grad, keys.reshape(-1),
                              demb.reshape(-1, d).to(torch.float32) / n_micro)
            gsum = dg if gsum is None else {k: gsum[k] + dg[k] for k in gsum}
            losses.append(loss)
        gmean = {k: g * (1.0 / n_micro) for k, g in gsum.items()}
        lr = lr_sched(state.step)
        new_dense, new_opt, gnorm = optimizer.update(state.dense, state.opt,
                                                     gmean, lr)

        touched = (table_grad != 0.0).any(-1)
        accum = state.table.accum + torch.where(
            touched, (table_grad * table_grad).mean(-1), table_grad.new_zeros(()))
        scale = torch.full((), sparse_lr, dtype=torch.float32, device=rows.device) \
            / (torch.sqrt(torch.clamp(accum, min=0.0)) + sparse_eps)
        scale = torch.where(touched, scale, scale.new_zeros(()))[:, None]
        new_rows = torch.addcmul(rows, scale, table_grad, value=-1).to(rows.dtype)
        aux = {"loss": torch.stack(losses).mean(), "grad_norm": gnorm, "lr": lr}
        new_table = EmbeddingTableState(new_rows, accum)
        return TrainState(new_dense, new_opt, new_table, state.step + 1), aux

    return step
