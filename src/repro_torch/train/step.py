"""Step builders (``repro.train.step`` in PyTorch): the pieces the DBP
driver composes around a store, and the serial (TorchRec-like) baseline.

The pipelined driver runs stages 5 + 5' here (``window_step``: the FWP
window over batch t, dense AdamW, the buffer's rowwise Adagrad) and the
stage-4b repair (``sync_buffers``); stages 3 (routing), 4a (retrieval) and
5'' (the writeback) are the store's ``plan``, ``retrieve`` and ``commit``.
Retrieval for t+1 reads the master *before* commit t writes it (stale on
purpose): keys in K(t) ∩ K(t+1) are repaired by the sync, keys outside
K(t) were never touched, so the step is exactly synchronous.

JAX's split-phase jits and donation contract have no port: PyTorch runs
eagerly and the commit writes the master in place. What stays is the
order. The retrieve for t+1 gathers into a fresh tensor before the commit
of t writes the master, and ``buf_updated`` is read by both the sync and
the commit and written by neither.

There is no dense-gradient reducer: ``dense_comm`` re-reduces grads across
replicas, and the port has one rank (multi-rank is ``ROADMAP.md`` Queue 1).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..core.embedding.engine import EmbeddingEngine, GradPacket
from ..core.fwp.executor import build_fwp_window, value_and_grad
from .optim import OptimizerPair
from .state import TrainState


class StepFns(NamedTuple):
    window_step: Callable  # (state, buffer, plan, batch) -> (state, aux, buf_updated)
    sync_buffers: Callable  # (active, prefetch) -> DualBuffer [stage 4b]
    serial_step_noupd: Callable  # (state, batch) -> (state[old table], aux, pkts)
    commit_packets: Callable  # (table, pkts) -> table   [serial master update]


def build_step_fns(
    engine: EmbeddingEngine,
    loss_fn: Callable,  # (dense_params, emb, mb_batch) -> (loss, metrics)
    optimizer: OptimizerPair,
    lr_sched: Callable,
    n_micro: int,
    mb_keys_shape: Tuple[int, ...],
) -> StepFns:
    window_fn = build_fwp_window(engine, loss_fn, n_micro, mb_keys_shape)

    def window_step(state: TrainState, buffer, plan, batch):
        """Stages 5 + 5': FWP window over batch t + frozen-window updates
        (dense AdamW, buffer rowwise Adagrad). The table in ``state`` is
        passed through: the store owns the master during a run."""
        out = window_fn(state.dense, buffer, plan, batch)
        lr = lr_sched(state.step)
        new_dense, new_opt, gnorm = optimizer.update(
            state.dense, state.opt, out.dense_grads, lr)
        buf_updated = engine.apply_window_to_buffer(buffer, out.packets)
        aux = {
            "loss": out.loss,
            "grad_norm": gnorm,
            "lr": lr,
            "routing_overflow": engine.overflow_metric(plan),
            **out.metrics,
        }
        new_state = TrainState(new_dense, new_opt, state.table, state.step + 1)
        return new_state, aux, buf_updated

    def serial_step_noupd(state: TrainState, batch):
        """Fully synchronous flat step: each micro-batch looks its keys up
        straight from the master, one forward/backward each, no pipelining;
        the same math as NestPipe. Returns the packets; the master update
        runs in ``commit_packets``."""
        packets, losses = [], []
        gsum = None
        for i in range(n_micro):
            mb = {k: v[i] for k, v in batch.items()}
            emb, plan = engine.lookup_from_master(state.table, mb["keys"])
            (loss, _), (dg, demb) = value_and_grad(loss_fn, state.dense, emb, mb)
            packets.append(engine.grads_to_owner(
                plan, demb * (1.0 / n_micro), mb_keys_shape, n_micro))
            losses.append(loss)
            gsum = dg if gsum is None else {k: gsum[k] + dg[k] for k in gsum}
        pkts = GradPacket(torch.stack([p.keys for p in packets]),
                          torch.stack([p.grads for p in packets]))
        gmean = {k: g * (1.0 / n_micro) for k, g in gsum.items()}
        lr = lr_sched(state.step)
        new_dense, new_opt, gnorm = optimizer.update(state.dense, state.opt,
                                                     gmean, lr)
        aux = {"loss": torch.stack(losses).mean(), "grad_norm": gnorm, "lr": lr}
        return TrainState(new_dense, new_opt, state.table, state.step + 1), aux, pkts

    return StepFns(window_step, engine.sync_buffers, serial_step_noupd,
                   engine.apply_packets_to_master)
