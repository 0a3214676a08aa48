"""Training: dense optimizers, the train state and the step builders."""
from .optim import (
    AdamState,
    OptimizerPair,
    SgdState,
    clip_by_global_norm,
    constant_lr,
    global_norm,
    make_adamw,
    make_optimizer,
    make_sgd,
)
from .state import PipelineCarry, TrainState, clone_state
from .step import StepFns, build_step_fns

__all__ = ["AdamState", "OptimizerPair", "SgdState", "clip_by_global_norm",
           "constant_lr", "global_norm", "make_adamw", "make_optimizer",
           "make_sgd", "PipelineCarry", "TrainState", "clone_state",
           "StepFns", "build_step_fns"]
