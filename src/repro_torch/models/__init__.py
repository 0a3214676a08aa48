"""Models: the DLRM dense head."""
from .dlrm import DLRM, dlrm_forward, num_feature_slots, pool_tables

__all__ = ["DLRM", "dlrm_forward", "num_feature_slots", "pool_tables"]
