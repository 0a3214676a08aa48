"""Train state shared by the driver, the baselines and the reference
trainer (``repro.train.state``)."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..core.embedding.engine import DualBuffer, WindowPlan
from ..core.embedding.table import EmbeddingTableState


class TrainState(NamedTuple):
    """Full training state: dense params + optimizer + sparse master table."""

    dense: Dict[str, torch.Tensor]  # DLRM state-dict names -> tensors
    opt: Any  # AdamState | SgdState
    table: EmbeddingTableState
    step: torch.Tensor  # () int32


class PipelineCarry(NamedTuple):
    """Steady-state NestPipe carry between consecutive batches: the
    (already synced) buffer serving batch t and its window plan."""

    buffer: DualBuffer
    plan: WindowPlan


def clone_state(state: TrainState, device=None) -> TrainState:
    """A deep copy, on ``device`` if given: the master is updated in place
    by the DBP commit, so runs that must start from one state each take
    their own."""
    def cp(tree):
        if isinstance(tree, torch.Tensor):
            return tree.to(device, copy=True) if device is not None else tree.clone()
        if isinstance(tree, dict):
            return {k: cp(v) for k, v in tree.items()}
        return type(tree)(*(cp(x) for x in tree))

    return cp(state)
