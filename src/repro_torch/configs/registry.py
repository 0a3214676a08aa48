"""Architecture registry, recsys subset: ``--arch <id>`` -> full/reduced
configs. The DLRM archs and HSTU are ported; FuXi is not."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from . import recsys_archs
from .base import RecsysModelConfig

_RECSYS = {
    "hstu-industrial": ("HSTU_INDUSTRIAL", "HSTU_REDUCED"),
    "dlrm-ctr": ("DLRM_CTR", "DLRM_REDUCED"),
    "dlrm-routing": ("DLRM_ROUTING", "DLRM_ROUTING"),
    "dlrm-cached": ("DLRM_CACHED", "DLRM_CACHED"),
    "dlrm-drift": ("DLRM_DRIFT", "DLRM_DRIFT"),
    "dlrm-growth": ("DLRM_GROWTH", "DLRM_GROWTH"),
}

RECSYS_ARCHS: Tuple[str, ...] = tuple(_RECSYS)


@dataclass(frozen=True)
class ArchSpec:
    name: str
    kind: str  # "recsys"
    config: RecsysModelConfig
    reduced: RecsysModelConfig


def get_arch(name: str) -> ArchSpec:
    if name in _RECSYS:
        full, red = _RECSYS[name]
        return ArchSpec(name, "recsys", getattr(recsys_archs, full),
                        getattr(recsys_archs, red))
    raise KeyError(f"unknown or unported arch '{name}'; available: "
                   f"{sorted(RECSYS_ARCHS)}")
