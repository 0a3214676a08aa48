"""Models: the DLRM dense head and its loss."""
from .dlrm import (
    DLRM,
    dlrm_forward,
    make_dlrm_loss_fn,
    num_feature_slots,
    pool_tables,
)

__all__ = ["DLRM", "dlrm_forward", "make_dlrm_loss_fn", "num_feature_slots",
           "pool_tables"]
