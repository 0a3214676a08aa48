"""Workload resolution, recsys subset: (arch x batch x mode x device) -> the
mega-table spec, the engine, the batch shapes, the step functions and the
initial train state."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import NestPipeConfig, OptimizerConfig, RecsysModelConfig
from ..configs.registry import ArchSpec, get_arch
from ..core.embedding import EmbeddingEngine, init_table_state, make_mega_table_spec
from ..core.embedding.table import MegaTableSpec
from ..models.dlrm import DLRM, make_dlrm_loss_fn, num_feature_slots
from ..train import (
    OptimizerPair,
    StepFns,
    TrainState,
    build_step_fns,
    constant_lr,
    make_optimizer,
)

# Recsys training batch (per-worker hundreds of samples x 256 workers).
RECSYS_GLOBAL_BATCH = 65536


@dataclass
class Workload:
    arch: ArchSpec
    cfg: RecsysModelConfig
    mode: str
    npcfg: NestPipeConfig
    spec: MegaTableSpec
    engine: EmbeddingEngine
    n_micro: int
    batch_shapes: Dict[str, Tuple[Tuple[int, ...], Any]]
    device: torch.device

    @property
    def global_batch(self) -> int:
        n_micro, mb = self.batch_shapes["keys"][0][:2]
        return n_micro * mb

    def step_fns(self, opt_cfg: Optional[OptimizerConfig] = None
                 ) -> Tuple[StepFns, OptimizerPair]:
        opt_cfg = opt_cfg or OptimizerConfig()
        optimizer = make_optimizer(opt_cfg)
        mb_keys_shape = self.batch_shapes["keys"][0][1:]
        fns = build_step_fns(
            self.engine, make_dlrm_loss_fn(self.cfg), optimizer,
            constant_lr(opt_cfg.lr, self.device), self.n_micro, mb_keys_shape)
        return fns, optimizer

    def init_state(self, generator: torch.Generator,
                   optimizer: OptimizerPair) -> TrainState:
        """Dense params, then the master table, drawn on the device from
        ``generator``; a fresh optimizer state; step 0."""
        model = DLRM(self.cfg, device=self.device, generator=generator)
        params = {k: v.detach() for k, v in model.state_dict().items()}
        table = init_table_state(self.spec, device=self.device, generator=generator)
        return TrainState(params, optimizer.init(params), table,
                          torch.zeros((), dtype=torch.int32, device=self.device))


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
    mode: str = "nestpipe",
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
    if global_batch % n_micro:
        raise ValueError(f"global_batch={global_batch} is not a multiple of "
                         f"n_micro={n_micro}")
    spec = make_mega_table_spec(cfg.tables, num_shards=1)
    engine = EmbeddingEngine(spec, npcfg, device=device,
                             compute_dtype=getattr(torch, cfg.compute_dtype))
    return Workload(
        arch=arch, cfg=cfg, mode=mode, npcfg=npcfg, spec=spec, engine=engine,
        n_micro=n_micro, batch_shapes=batch_shapes(cfg, global_batch, n_micro),
        device=device,
    )
