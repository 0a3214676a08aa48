"""Carry weights and train state from the JAX package into the port, as
numpy arrays.

JAX's threefry ``jax.random`` cannot be reproduced with ``torch.Generator``,
so a port that must serve or train from the same weights takes them over:
the DLRM dense pytree as a state dict, the master table as an
``EmbeddingTableState`` (hand both to ``Session.ingest``), or a whole
train state, AdamW moments and step included (assign it to
``Session.state``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from .core.embedding.table import EmbeddingTableState
from .train.optim import AdamState
from .train.state import TrainState


def dlrm_params_from_jax(
        params_np: Mapping[str, Sequence[Mapping[str, Any]]]) -> Dict[str, torch.Tensor]:
    """``{"bottom": [{"w", "b"}, ...], "top": [...]}`` -> a ``DLRM`` state
    dict. ``w`` keeps its (in, out) layout."""
    out: Dict[str, torch.Tensor] = {}
    for part in ("bottom", "top"):
        for i, layer in enumerate(params_np[part]):
            for name in ("w", "b"):
                out[f"{part}.{i}.{name}"] = torch.from_numpy(
                    np.array(layer[name], dtype=np.float32))
    return out


def table_from_jax(rows_np: np.ndarray, accum_np: np.ndarray,
                   device: torch.device | str) -> EmbeddingTableState:
    """The JAX master table ``(Vp, D)`` and adagrad state ``(Vp,)`` on
    ``device``."""
    return EmbeddingTableState(
        rows=torch.from_numpy(np.array(rows_np, dtype=np.float32)).to(device),
        accum=torch.from_numpy(np.array(accum_np, dtype=np.float32)).to(device),
    )


def train_state_from_jax(state_np, device: torch.device | str) -> TrainState:
    """A JAX ``TrainState`` of numpy arrays (DLRM dense pytree, AdamW
    ``AdamState(step, mu, nu)``, master table, step) -> the port's, on
    ``device``, so both packages start from one state."""
    def params(tree):
        return {k: v.to(device) for k, v in dlrm_params_from_jax(tree).items()}

    opt = state_np.opt
    return TrainState(
        dense=params(state_np.dense),
        opt=AdamState(torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                                   device=device),
                      params(opt.mu), params(opt.nu)),
        table=table_from_jax(state_np.table.rows, state_np.table.accum, device),
        step=torch.tensor(int(np.asarray(state_np.step)), dtype=torch.int32,
                          device=device),
    )
