"""Embedding engine (routing, table layout, lookup ops), single device."""
from .engine import (
    DualBuffer,
    EmbeddingEngine,
    EngineDims,
    LookupPlan,
    WindowPlan,
)
from .routing import SENTINEL, owner_of
from .table import (
    EmbeddingTableState,
    MegaTableSpec,
    init_table_state,
    make_mega_table_spec,
)
