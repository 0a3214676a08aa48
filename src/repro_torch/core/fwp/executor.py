"""Frozen-Window Pipelining executor (paper §V), ``repro.core.fwp.executor``
in PyTorch.

Builds the window function that runs N micro-batches through (embedding
lookup from the buffer -> dense forward/backward -> gradient exchange to
owners) with NO parameter update until the window closes: the
parameter-freezing that makes the overlap semantically free (Prop. 2).

The loop is unrolled in Python. JAX gates each micro-batch's dense
forward behind the previous backward with ``jax.lax.optimization_barrier``
so XLA cannot hoist all N forwards and hold N micro-batches of
activations. Eager PyTorch needs no counterpart: ops run in program order
on one stream, so backward(i) is issued before forward(i+1), and only one
micro-batch's activations are alive at a time.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ..embedding.engine import DualBuffer, EmbeddingEngine, GradPacket, LookupPlan, WindowPlan


class FwpStepOutputs(NamedTuple):
    loss: torch.Tensor  # () mean loss over the window
    dense_grads: Dict[str, torch.Tensor]  # mean dense grads (sum of g_i / N)
    packets: GradPacket  # stacked (N, ...) gradient packets for the sparse side
    metrics: Dict[str, torch.Tensor]  # auxiliary metrics (mean over micro-batches)


def value_and_grad(loss_fn: Callable, params: Dict[str, torch.Tensor],
                   emb: torch.Tensor, mb):
    """``((loss, metrics), (dparams, demb))``, as ``jax.value_and_grad(
    loss_fn, argnums=(0, 1), has_aux=True)``: params and emb are taken as
    fresh leaves, so nothing outside sees a ``.grad``."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    emb = emb.detach().requires_grad_()
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, emb, mb)
        grads = torch.autograd.grad(loss, [*leaves.values(), emb])
    dparams = dict(zip(leaves, grads[:-1]))
    return (loss.detach(), metrics), (dparams, grads[-1])


def build_fwp_window(
    engine: EmbeddingEngine,
    loss_fn: Callable,  # loss_fn(dense_params, emb, mb_batch) -> (loss, metrics)
    n_micro: int,
    mb_keys_shape: Tuple[int, ...],
):
    """Returns ``window(dense_params, buffer, window_plan, mb_batches)``.

    ``mb_batches``: dict of tensors stacked (N, ...) with a ``keys`` field of
    shape (N, *mb_keys_shape); ``window_plan`` from ``engine.route_window``.
    The dense grads come back averaged over the window (the sum of each
    micro-batch's grads scaled by 1/N, in that order, as JAX sums them) and
    the packets carry the 1/N-scaled sparse grads, so the updates reproduce
    Eq. (1).
    """
    scale = 1.0 / n_micro

    def window(dense_params, buffer: DualBuffer, window_plan: WindowPlan,
               mb_batches) -> FwpStepOutputs:
        losses, all_metrics, packets = [], [], []
        gsum = None
        for i in range(n_micro):
            plan_i = LookupPlan(*(x[i] for x in window_plan.plans))
            mb_i = {k: v[i] for k, v in mb_batches.items()}
            emb = engine.lookup_from_buffer(buffer, plan_i, mb_keys_shape, n_micro)
            (loss, metrics), (dg, demb) = value_and_grad(
                loss_fn, dense_params, emb, mb_i)
            pkt = engine.grads_to_owner(plan_i, demb * scale, mb_keys_shape,
                                        n_micro)
            dg = {k: g * scale for k, g in dg.items()}
            gsum = dg if gsum is None else {k: gsum[k] + dg[k] for k in gsum}
            losses.append(loss)
            all_metrics.append(metrics)
            packets.append(pkt)
        pkts = GradPacket(torch.stack([p.keys for p in packets]),
                          torch.stack([p.grads for p in packets]))
        metrics = {k: torch.stack([m[k] for m in all_metrics]).mean()
                   for k in all_metrics[0]}
        return FwpStepOutputs(torch.stack(losses).mean(), gsum, pkts, metrics)

    return window
