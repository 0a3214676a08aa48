"""Architecture registry: ``--arch <id>`` -> full/reduced configs. Ported:
the recsys archs (DLRM, HSTU, FuXi; training), the LM archs whose
(attn | mamba, mlp | moe | none) stacks the port's layers cover
(``kind="lm"``, training and serving), among them the vision-language
pixtral-12b (stub patch embeddings ahead of the text), and the
encoder-decoder whisper-base (``kind="encdec"``, training and serving)."""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Tuple, Union

from . import recsys_archs
from .base import ModelConfig, RecsysModelConfig

_LM_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "stablelm-12b": "stablelm_12b",
    "nemotron-4-340b": "nemotron_4_340b",
    "yi-34b": "yi_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "grok-1-314b": "grok_1_314b",
    "mamba2-370m": "mamba2_370m",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "whisper-base": "whisper_base",
    "pixtral-12b": "pixtral_12b",
}

_RECSYS = {
    "hstu-industrial": ("HSTU_INDUSTRIAL", "HSTU_REDUCED"),
    "fuxi-kuairand": ("FUXI_KUAIRAND", "FUXI_REDUCED"),
    "dlrm-ctr": ("DLRM_CTR", "DLRM_REDUCED"),
    "dlrm-routing": ("DLRM_ROUTING", "DLRM_ROUTING"),
    "dlrm-cached": ("DLRM_CACHED", "DLRM_CACHED"),
    "dlrm-drift": ("DLRM_DRIFT", "DLRM_DRIFT"),
    "dlrm-growth": ("DLRM_GROWTH", "DLRM_GROWTH"),
}

LM_ARCHS: Tuple[str, ...] = tuple(_LM_MODULES)
RECSYS_ARCHS: Tuple[str, ...] = tuple(_RECSYS)


@dataclass(frozen=True)
class ArchSpec:
    name: str
    kind: str  # "lm" | "encdec" | "recsys"
    config: Union[ModelConfig, RecsysModelConfig]
    reduced: Union[ModelConfig, RecsysModelConfig]


def get_arch(name: str) -> ArchSpec:
    if name in _LM_MODULES:
        mod = importlib.import_module(f".{_LM_MODULES[name]}", __package__)
        kind = "encdec" if mod.CONFIG.encoder is not None else "lm"
        return ArchSpec(name, kind, mod.CONFIG, mod.REDUCED)
    if name in _RECSYS:
        full, red = _RECSYS[name]
        return ArchSpec(name, "recsys", getattr(recsys_archs, full),
                        getattr(recsys_archs, red))
    raise KeyError(f"unknown or unported arch '{name}'; ported: LM "
                   f"{sorted(LM_ARCHS)}, recsys {sorted(RECSYS_ARCHS)}")
