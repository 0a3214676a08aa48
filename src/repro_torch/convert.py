"""Carry weights and train state from the JAX package into the port, as
numpy arrays.

JAX's threefry ``jax.random`` cannot be reproduced with ``torch.Generator``,
so a port that must serve or train from the same weights takes them over:
the DLRM, HSTU or FuXi dense pytree as a state dict, the master table as an
``EmbeddingTableState`` (hand both to ``Session.ingest``), or a whole
train state, AdamW moments and step included (assign it to
``Session.state``). A dense LM's params (``lm_params_from_jax``) keep
their dtypes: bf16 stays bf16. A checkpoint directory the JAX package
wrote (``repro.dist.checkpoint``) reads into a port train state with
``train_state_from_jax_checkpoint``, through numpy alone.
"""
from __future__ import annotations

import ast
import re
from types import SimpleNamespace
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.embedding.table import EmbeddingTableState
from .dist.checkpoint import BF16_DTYPE, read_manifest, verify_leaf
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
    its keys: a dense LM's ``blocks`` (``lm_params_from_jax``), DLRM's
    ``bottom`` and ``top``, HSTU's layers (``w_uvqk``) or FuXi's
    (``w_fi0``); an encoder-decoder's ``encoder`` and ``decoder`` go through
    ``lm_params_from_jax`` too."""
    if "blocks" in params_np or "encoder" in params_np:
        return lm_params_from_jax(params_np)
    if "layers" not in params_np:
        return dlrm_params_from_jax(params_np)
    if "w_uvqk" in params_np["layers"]:
        return hstu_params_from_jax(params_np)
    if "w_fi0" in params_np["layers"]:
        return fuxi_params_from_jax(params_np)
    raise ValueError(f"no ported backbone has the layer keys {sorted(params_np['layers'])}")


def _tensor_keep_dtype(x) -> torch.Tensor:
    """A numpy (or ml_dtypes bfloat16) array as a tensor of the same dtype; a
    tensor as it is."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # no numpy dtype in torch: move the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def lm_params_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX's LM pytree ``{"blocks": [block per pattern position, leaves
    stacked (n_rep, ...)], "final_norm", "head_w"}`` -> the port's params
    (``blocks.{p}.attn.wq``, ..., ``final_norm.scale``, ``head_w``), one to
    one, stacked axes and dtypes kept. Any other tree flattens by its keys
    the same way: the encoder-decoder's ``{"encoder": {"norm1", "attn",
    ...}, "decoder": {...}, "enc_norm", "final_norm", "head_w"}`` becomes
    ``encoder.attn.wq`` (n_layers, ...), ..., ``enc_norm.scale``."""
    def flat(tree, prefix):
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}.{k}")
        else:
            yield prefix, tree

    out: Dict[str, torch.Tensor] = {}
    for key, tree in params_np.items():
        subtrees = ([(f"blocks.{pos}", block) for pos, block in enumerate(tree)]
                    if key == "blocks" else [(key, tree)])
        for prefix, sub in subtrees:
            for name, leaf in flat(sub, prefix):
                out[name] = _tensor_keep_dtype(leaf)
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
    """A JAX ``TrainState`` of numpy arrays (dense LM, DLRM, HSTU or FuXi
    dense pytree, AdamW ``AdamState(step, mu, nu)``, master table, step) ->
    the port's, on
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


_KEY = re.compile(r"\.(\w+)|\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]")


def _parse_keystr(path: str) -> List[Any]:
    """A JAX keystr (``.dense['bottom'][0]['w']``) as its keys: an
    attribute as ``("attr", name)``, a dict key as its string, a sequence
    index as its int."""
    keys, pos = [], 0
    for m in _KEY.finditer(path):
        if m.start() != pos:
            break
        attr, key, idx = m.groups()
        keys.append(("attr", attr) if attr is not None else
                    ast.literal_eval(f"'{key}'") if key is not None else int(idx))
        pos = m.end()
    if pos != len(path) or not keys:
        raise ValueError(f"not a JAX keystr: {path!r}")
    return keys


def _unflatten_keystr(leaves: Sequence[Tuple[str, Any]]) -> Any:
    """Nest ``(keystr, leaf)`` pairs back into a tree: attributes become
    ``SimpleNamespace`` fields, dict keys dicts, indices lists (in order)."""
    root: Dict[Any, Any] = {}
    for path, leaf in leaves:
        keys = _parse_keystr(path)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(isinstance(k, tuple) for k in node):
            return SimpleNamespace(**{k[1]: build(v) for k, v in node.items()})
        if all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"indices {sorted(node)} are not 0..{len(node) - 1}")
            return [build(node[i]) for i in range(len(node))]
        if all(isinstance(k, str) for k in node):
            return {k: build(v) for k, v in node.items()}
        raise ValueError(f"mixed key kinds in one node: {sorted(map(repr, node))}")

    return build(root)


def train_state_from_jax_checkpoint(ckpt_dir: str, device: torch.device | str,
                                    step: Optional[int] = None) -> TrainState:
    """A checkpoint the JAX package wrote (``repro.dist.checkpoint``: a
    ``step_%08d`` directory, its manifest and ``.npy`` leaves) at ``step``
    (default: the latest) -> the port's train state on ``device``. Each
    leaf's CRC32 is verified and every file read by numpy alone (no
    pickle); JAX's keystr paths rebuild the numpy tree that
    ``train_state_from_jax`` takes (HSTU's and FuXi's stacked ``layers``
    leaves are unstacked there)."""
    d, manifest = read_manifest(ckpt_dir, step)
    leaves = [(e["path"], _read_leaf(verify_leaf(d, e), e["dtype"]))
              for e in manifest["leaves"]]
    return train_state_from_jax(_unflatten_keystr(leaves), device)


def _read_leaf(fpath: str, dtype: str):
    """A leaf file as numpy reads it; a bfloat16 leaf (two raw bytes an
    element on disk, ``dist.checkpoint.BF16_DTYPE`` in the manifest) as a
    bfloat16 tensor of its bits."""
    a = np.load(fpath, allow_pickle=False)
    if dtype == BF16_DTYPE:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return a
