"""Workload resolution: (arch x shape x mode x device) -> the mega-table
spec, the engine, the batch shapes and, for a recsys arch, the step
functions and the initial train state. A recsys dense model is picked by
the config's backbone (``dlrm``, ``hstu`` or ``fuxi``); a dense LM (``kind == "lm"``)
resolves to its serving bundle over a single-vocab table."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs.base import (
    ModelConfig,
    NestPipeConfig,
    OptimizerConfig,
    RecsysModelConfig,
)
from ..configs.registry import ArchSpec, get_arch
from ..core.embedding import EmbeddingEngine, init_table_state, make_mega_table_spec
from ..core.embedding.table import MegaTableSpec
from ..models.dlrm import DLRM, LossFn, make_dlrm_loss_fn, num_feature_slots
from ..models.fuxi import FuXi, make_fuxi_loss_fn
from ..models.hstu import HSTU, make_hstu_loss_fn
from ..models.zoo import LMBundle, build_lm_bundle
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


# What an LM workload answers when asked to train: the port serves dense
# LMs, and their training is a later slice.
LM_TRAINING_NOT_PORTED = (
    "LM training is not ported: the port serves dense LMs only "
    "(ROADMAP.md, Queue 1, item 4b: LM training, which needs a logsumexp "
    "output from the wgmma flash_attention forward)")


@dataclass
class Workload:
    arch: ArchSpec
    cfg: Union[RecsysModelConfig, ModelConfig]
    mode: str
    npcfg: NestPipeConfig
    spec: MegaTableSpec
    engine: EmbeddingEngine
    n_micro: int
    batch_shapes: Dict[str, Tuple[Tuple[int, ...], Any]]
    device: torch.device
    # LM workloads only: the serving bundle
    bundle: Optional[LMBundle] = None

    @property
    def global_batch(self) -> int:
        n_micro, mb = self.batch_shapes["keys"][0][:2]
        return n_micro * mb

    def step_fns(self, opt_cfg: Optional[OptimizerConfig] = None
                 ) -> Tuple[StepFns, OptimizerPair]:
        if self.bundle is not None:
            raise NotImplementedError(LM_TRAINING_NOT_PORTED)
        opt_cfg = opt_cfg or OptimizerConfig()
        optimizer = make_optimizer(opt_cfg)
        mb_keys_shape = self.batch_shapes["keys"][0][1:]
        fns = build_step_fns(
            self.engine, make_loss_fn(self.cfg), optimizer,
            constant_lr(opt_cfg.lr, self.device), self.n_micro, mb_keys_shape)
        return fns, optimizer

    def init_state(self, generator: torch.Generator,
                   optimizer: OptimizerPair) -> TrainState:
        """Dense params, then the master table, drawn on the device from
        ``generator``; a fresh optimizer state; step 0."""
        if self.bundle is not None:
            raise NotImplementedError(LM_TRAINING_NOT_PORTED)
        model = dense_model(self.cfg, device=self.device, generator=generator)
        params = {k: v.detach() for k, v in model.state_dict().items()}
        table = init_table_state(self.spec, device=self.device, generator=generator)
        return TrainState(params, optimizer.init(params), table,
                          torch.zeros((), dtype=torch.int32, device=self.device))


# backbone -> (dense module, loss-function factory)
BACKBONES = {"dlrm": (DLRM, make_dlrm_loss_fn), "hstu": (HSTU, make_hstu_loss_fn),
             "fuxi": (FuXi, make_fuxi_loss_fn)}


def _backbone(cfg: RecsysModelConfig):
    try:
        return BACKBONES[cfg.backbone]
    except KeyError:
        raise NotImplementedError(f"backbone {cfg.backbone!r} is not ported; "
                                  f"ported: {sorted(BACKBONES)}") from None


def make_loss_fn(cfg: RecsysModelConfig) -> LossFn:
    """The training loss of the config's backbone."""
    return _backbone(cfg)[1](cfg)


def dense_model(cfg: RecsysModelConfig, *, device, generator: torch.Generator):
    """The dense module of the config's backbone, drawn from ``generator``."""
    return _backbone(cfg)[0](cfg, device=device, generator=generator)


def batch_shapes(cfg: RecsysModelConfig, global_batch: int,
                 n_micro: int) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """{field: ((N, mb, ...), dtype)} for one window: DLRM's keys, dense
    features and labels, or the item-id sequences of a sequential model."""
    mb = global_batch // n_micro
    if cfg.backbone != "dlrm":
        return {"keys": ((n_micro, mb, cfg.seq_len), torch.int32)}
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
    """A recsys arch at ``global_batch``, or a dense LM (which serves any
    batch and prompt, and so takes no batch here)."""
    arch = get_arch(arch_name)
    if arch.kind == "lm":
        return _resolve_lm(arch, arch.reduced if reduced else arch.config,
                           device=device, mode=mode, npcfg=npcfg)
    return assemble_workload(arch, arch.reduced if reduced else arch.config,
                             device=device, mode=mode, npcfg=npcfg,
                             global_batch=global_batch)


def assemble_workload(
    arch: ArchSpec,
    cfg: RecsysModelConfig,
    *,
    device: torch.device | str,
    mode: str = "nestpipe",
    npcfg: Optional[NestPipeConfig] = None,
    global_batch: int = RECSYS_GLOBAL_BATCH,
) -> Workload:
    """Assemble the workload of ``cfg`` on one device: what ``resolve``
    does for a registry arch, and what a hand-assembled config (one
    outside the registry) goes through before ``Session.from_workload``."""
    _backbone(cfg)
    device = torch.device(device)
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


def _resolve_lm(arch: ArchSpec, cfg: ModelConfig, *, device, mode: str,
                npcfg: Optional[NestPipeConfig]) -> Workload:
    """JAX ``resolve`` for ``kind == "lm"`` on one device: the vocab as a
    single-table spec and an engine at the config's compute dtype. Serving
    takes no FWP micro-batches, and the batch is the caller's, so the
    workload has no batch shapes."""
    device = torch.device(device)
    npcfg = npcfg or NestPipeConfig()
    bundle = build_lm_bundle(cfg)
    spec = make_mega_table_spec(None, vocab_size=cfg.vocab_size, dim=bundle.emb_dim,
                                num_shards=1)
    engine = EmbeddingEngine(spec, npcfg, device=device,
                             compute_dtype=getattr(torch, cfg.compute_dtype))
    return Workload(arch=arch, cfg=cfg, mode=mode, npcfg=npcfg, spec=spec,
                    engine=engine, n_micro=1, batch_shapes={}, device=device,
                    bundle=bundle)
