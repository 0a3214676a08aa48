"""Models: the DLRM dense head, the HSTU backbone, and their losses."""
from .dlrm import (
    DLRM,
    dlrm_forward,
    make_dlrm_loss_fn,
    num_feature_slots,
    pool_tables,
)
from .hstu import (
    HSTU,
    hstu_forward,
    hstu_layer,
    make_hstu_loss_fn,
    sequence_infonce,
)
from .layers import apply_norm, init_norm

__all__ = ["DLRM", "dlrm_forward", "make_dlrm_loss_fn", "num_feature_slots",
           "pool_tables", "HSTU", "hstu_forward", "hstu_layer",
           "make_hstu_loss_fn", "sequence_infonce", "apply_norm", "init_norm"]
