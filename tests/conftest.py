"""Suite-wide pytest wiring.

Registers the ``multidev`` marker for the multi-device scenario SWEEPS
(subprocesses forcing ``--xla_force_host_platform_device_count``): the
default job shows them as SKIPPED — visible, not silently uncollected —
and CI's dedicated ``multidev`` job opts in with ``REPRO_MULTIDEV=1``.
The core multi-device proofs (tests/test_sharded_store.py) stay unmarked
so the tier-1 run always exercises them.
"""
import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidev: multi-device scenario sweep; skipped unless "
        "REPRO_MULTIDEV=1 (run by CI's multidev job)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (hand-written CUDA kernels); skips "
        "without one")


def pytest_collection_modifyitems(config, items):
    if os.environ.get("REPRO_MULTIDEV") == "1":
        return
    skip = pytest.mark.skip(
        reason="multidev sweep: set REPRO_MULTIDEV=1 (CI multidev job)")
    for item in items:
        if "multidev" in item.keywords:
            item.add_marker(skip)
