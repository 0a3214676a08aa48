"""Workload resolution: (arch x shape x mode x device) -> the mega-table
spec, the engine, the batch shapes, the step functions and the initial
train state. A recsys dense model is picked by the config's backbone
(``dlrm``, ``hstu`` or ``fuxi``); an LM (``kind == "lm"``) or an
encoder-decoder (``kind == "encdec"``) resolves to its bundle (training
loss, prefill, decode) over a single-vocab table."""
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
from ..models.zoo import LMBundle, build_encdec_bundle, build_lm_bundle, train_batch_shapes
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
# JAX's train_4k shape (src/repro/configs/shapes.py): an LM's default
# training batch and sequence length, and a custom shape's default for
# whichever of the two is not given
LM_TRAIN_4K = (256, 4096)
LM_CUSTOM_DEFAULT = 32


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
    # LM workloads only: the bundle, and the cross-entropy's chunk over T
    bundle: Optional[LMBundle] = None
    t_chunk: int = 512

    @property
    def global_batch(self) -> int:
        n_micro, mb = self.batch_shapes["keys"][0][:2]
        return n_micro * mb

    def step_fns(self, opt_cfg: Optional[OptimizerConfig] = None
                 ) -> Tuple[StepFns, OptimizerPair]:
        opt_cfg = opt_cfg or OptimizerConfig()
        optimizer = make_optimizer(opt_cfg)
        mb_keys_shape = self.batch_shapes["keys"][0][1:]
        loss_fn = (make_loss_fn(self.cfg) if self.bundle is None
                   else self.bundle.loss_fn(self.t_chunk))
        fns = build_step_fns(
            self.engine, loss_fn, optimizer,
            constant_lr(opt_cfg.lr, self.device), self.n_micro, mb_keys_shape)
        return fns, optimizer

    def init_state(self, generator: torch.Generator,
                   optimizer: OptimizerPair) -> TrainState:
        """Dense params (an LM's ``init_lm_params``), then the master
        table, drawn on the device from ``generator``; a fresh optimizer
        state; step 0."""
        if self.bundle is not None:
            params = self.bundle.init_params(generator, self.device)
        else:
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
    global_batch: Optional[int] = None,
    seq_len: Optional[int] = None,
    t_chunk: int = 512,
) -> Workload:
    """The registry arch ``arch_name`` (its reduced config when
    ``reduced``) through ``assemble_workload``."""
    arch = get_arch(arch_name)
    return assemble_workload(arch, arch.reduced if reduced else arch.config,
                             device=device, mode=mode, npcfg=npcfg,
                             global_batch=global_batch, seq_len=seq_len, t_chunk=t_chunk)


def assemble_workload(
    arch: ArchSpec,
    cfg: Union[RecsysModelConfig, ModelConfig],
    *,
    device: torch.device | str,
    mode: str = "nestpipe",
    npcfg: Optional[NestPipeConfig] = None,
    global_batch: Optional[int] = None,
    seq_len: Optional[int] = None,
    t_chunk: int = 512,
) -> Workload:
    """Assemble the workload of ``cfg`` on one device: what ``resolve``
    does for a registry arch, and what a hand-assembled config (one
    outside the registry) goes through before ``Session.from_workload``.

    A recsys config trains at ``global_batch`` (default
    ``RECSYS_GLOBAL_BATCH``; its sequence length is the config's). A dense
    LM (``arch.kind == "lm"``) or an encoder-decoder (``"encdec"``, its
    window carrying the frames too) trains at ``global_batch`` x
    ``seq_len`` tokens, with JAX's rule for the shape: ``train_4k`` when
    neither is given, else 32 for the one left out; its cross-entropy is
    chunked over ``t_chunk`` positions. Serving takes any batch and prompt
    whatever the training shape."""
    device = torch.device(device)
    npcfg = npcfg or NestPipeConfig()
    if arch.kind in ("lm", "encdec"):
        if global_batch is None and seq_len is None:
            global_batch, seq_len = LM_TRAIN_4K
        return _resolve_lm(arch, cfg, device=device, mode=mode, npcfg=npcfg,
                           global_batch=global_batch or LM_CUSTOM_DEFAULT,
                           seq_len=seq_len or LM_CUSTOM_DEFAULT, t_chunk=t_chunk)
    _backbone(cfg)
    global_batch = global_batch or RECSYS_GLOBAL_BATCH
    n_micro = _n_micro(npcfg, global_batch)
    spec = make_mega_table_spec(cfg.tables, num_shards=1)
    engine = EmbeddingEngine(spec, npcfg, device=device,
                             compute_dtype=getattr(torch, cfg.compute_dtype))
    return Workload(
        arch=arch, cfg=cfg, mode=mode, npcfg=npcfg, spec=spec, engine=engine,
        n_micro=n_micro, batch_shapes=batch_shapes(cfg, global_batch, n_micro),
        device=device,
    )


def _n_micro(npcfg: NestPipeConfig, global_batch: int) -> int:
    n_micro = npcfg.fwp_microbatches
    if global_batch % n_micro:
        raise ValueError(f"global_batch={global_batch} is not a multiple of "
                         f"n_micro={n_micro}")
    return n_micro


def _resolve_lm(arch: ArchSpec, cfg: ModelConfig, *, device: torch.device, mode: str,
                npcfg: NestPipeConfig, global_batch: int, seq_len: int,
                t_chunk: int) -> Workload:
    """JAX ``resolve`` for ``kind == "lm"`` and ``"encdec"`` on one device:
    the vocab as a single-table spec, an engine at the config's compute
    dtype, and the training window of ``global_batch`` sequences of
    ``seq_len`` tokens (and an encoder-decoder's frames) in N micro-batches
    (N = 1 under the serve strategy, whose batch and prompt the caller
    gives at ``Session.serve``). A VLM's ``seq_len`` positions are its
    patches, then ``seq_len - n_positions`` text keys (``seq_len`` must
    exceed ``n_positions``); its labels cover all ``seq_len``."""
    n_micro = _n_micro(npcfg, global_batch)
    bundle = build_encdec_bundle(cfg) if arch.kind == "encdec" else build_lm_bundle(cfg)
    spec = make_mega_table_spec(None, vocab_size=cfg.vocab_size, dim=bundle.emb_dim,
                                num_shards=1)
    engine = EmbeddingEngine(spec, npcfg, device=device,
                             compute_dtype=getattr(torch, cfg.compute_dtype))
    return Workload(arch=arch, cfg=cfg, mode=mode, npcfg=npcfg, spec=spec,
                    engine=engine, n_micro=n_micro,
                    batch_shapes=train_batch_shapes(global_batch, seq_len, n_micro, cfg),
                    device=device, bundle=bundle, t_chunk=t_chunk)
