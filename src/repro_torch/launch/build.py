"""Workload resolution, recsys subset: (arch x batch x device) -> the mega-table
spec, the engine and the batch shapes the serving path needs."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import NestPipeConfig, RecsysModelConfig
from ..configs.registry import ArchSpec, get_arch
from ..core.embedding import EmbeddingEngine, make_mega_table_spec
from ..core.embedding.table import MegaTableSpec
from ..models.dlrm import num_feature_slots

# Recsys training batch (per-worker hundreds of samples x 256 workers).
RECSYS_GLOBAL_BATCH = 65536


@dataclass
class Workload:
    arch: ArchSpec
    cfg: RecsysModelConfig
    npcfg: NestPipeConfig
    spec: MegaTableSpec
    engine: EmbeddingEngine
    n_micro: int
    batch_shapes: Dict[str, Tuple[Tuple[int, ...], Any]]
    device: torch.device


def batch_shapes(cfg: RecsysModelConfig, global_batch: int,
                 n_micro: int) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """{field: ((N, mb, ...), dtype)} for one DLRM window."""
    mb = global_batch // n_micro
    return {
        "keys": ((n_micro, mb, num_feature_slots(cfg)), torch.int32),
        "dense": ((n_micro, mb, cfg.num_dense_features), torch.float32),
        "labels": ((n_micro, mb), torch.float32),
    }


def resolve(
    arch_name: str,
    *,
    device: torch.device,
    npcfg: Optional[NestPipeConfig] = None,
    reduced: bool = False,
    global_batch: int = RECSYS_GLOBAL_BATCH,
) -> Workload:
    arch = get_arch(arch_name)
    cfg = arch.reduced if reduced else arch.config
    if cfg.backbone != "dlrm":
        raise NotImplementedError(f"backbone {cfg.backbone!r} is not ported")
    npcfg = npcfg or NestPipeConfig()
    n_micro = npcfg.fwp_microbatches
    spec = make_mega_table_spec(cfg.tables, num_shards=1)
    engine = EmbeddingEngine(spec, npcfg, device=device,
                             compute_dtype=getattr(torch, cfg.compute_dtype))
    return Workload(
        arch=arch, cfg=cfg, npcfg=npcfg, spec=spec, engine=engine,
        n_micro=n_micro, batch_shapes=batch_shapes(cfg, global_batch, n_micro),
        device=device,
    )
