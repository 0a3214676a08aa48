"""Carry weights and train state from the JAX package into the port, as
numpy arrays.

JAX's threefry ``jax.random`` cannot be reproduced with ``torch.Generator``,
so a port that must serve or train from the same weights takes them over:
the DLRM, HSTU or FuXi dense pytree as a state dict, the master table as an
``EmbeddingTableState`` (hand both to ``Session.ingest``), or a whole
train state, AdamW moments and step included (assign it to
``Session.state``). A dense LM's params (``lm_params_from_jax``) keep
their dtypes: bf16 stays bf16.
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


def hstu_params_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"layers": {...stacked (L, ...)}, "in_proj", "final_norm"}`` -> an
    ``HSTU`` state dict: the leading layer axis of every ``layers`` leaf is
    unstacked into ``layers.{i}.*``; weights keep their (in, out) layout."""
    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def flat(tree, prefix):
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}.{k}" if prefix else k)
        else:
            yield prefix, tree

    out: Dict[str, torch.Tensor] = {}
    for name, leaf in flat(params_np["layers"], ""):
        for i in range(np.shape(leaf)[0]):
            out[f"layers.{i}.{name}"] = f32(np.asarray(leaf)[i])
    out["in_proj"] = f32(params_np["in_proj"])
    for name, leaf in flat(params_np["final_norm"], "final_norm"):
        out[name] = f32(leaf)
    return out


def fuxi_params_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """FuXi's ``{"layers": {"norm1", "attn": {"wq", "wk", "wv", "wo"},
    "norm2", "w_up", "w_fi0".."w_fi2", "w_down"} stacked (L, ...), "in_proj",
    "final_norm"}`` -> a ``FuXi`` state dict (``layers.{i}.attn.wq``, ...,
    ``final_norm.scale``): HSTU's unstacking, which follows the keys."""
    return hstu_params_from_jax(params_np)


def dense_params_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The dense pytree of a ported backbone as a state dict, told apart by
    its keys: DLRM's ``bottom`` and ``top``, HSTU's layers (``w_uvqk``) or
    FuXi's (``w_fi0``)."""
    if "layers" not in params_np:
        return dlrm_params_from_jax(params_np)
    if "w_uvqk" in params_np["layers"]:
        return hstu_params_from_jax(params_np)
    if "w_fi0" in params_np["layers"]:
        return fuxi_params_from_jax(params_np)
    raise ValueError(f"no ported backbone has the layer keys {sorted(params_np['layers'])}")


def _tensor_keep_dtype(x) -> torch.Tensor:
    """A numpy (or ml_dtypes bfloat16) array as a tensor of the same dtype."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # no numpy dtype in torch: move the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def lm_params_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX's LM pytree ``{"blocks": [block per pattern position, leaves
    stacked (n_rep, ...)], "final_norm", "head_w"}`` -> the port's params
    (``blocks.{p}.attn.wq``, ..., ``final_norm.scale``, ``head_w``), one to
    one, stacked axes and dtypes kept."""
    def flat(tree, prefix):
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}.{k}")
        else:
            yield prefix, tree

    out: Dict[str, torch.Tensor] = {}
    for pos, block in enumerate(params_np["blocks"]):
        for name, leaf in flat(block, f"blocks.{pos}"):
            out[name] = _tensor_keep_dtype(leaf)
    for name, leaf in flat(params_np["final_norm"], "final_norm"):
        out[name] = _tensor_keep_dtype(leaf)
    out["head_w"] = _tensor_keep_dtype(params_np["head_w"])
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
    """A JAX ``TrainState`` of numpy arrays (DLRM, HSTU or FuXi dense pytree,
    AdamW ``AdamState(step, mu, nu)``, master table, step) -> the port's, on
    ``device``, so both packages start from one state."""
    def params(tree):
        return {k: v.to(device) for k, v in dense_params_from_jax(tree).items()}

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
