"""Embedding storage tiers behind one read surface (device tier only)."""
from .base import (
    STAGE_TIMER_KEYS,
    STORES,
    FetchPlan,
    StageTimers,
    build_store,
    placeholder_table,
    resolve_store,
)
from .device import DeviceStore

__all__ = ["STAGE_TIMER_KEYS", "STORES", "FetchPlan", "StageTimers",
           "build_store", "placeholder_table", "resolve_store", "DeviceStore"]
