"""Distributed-path pieces of the port (``repro.dist``): atomic manifest
checkpoints (``checkpoint``), the host codecs of the sparse data path
(``compressed``), the fault policies (``fault``: the preemption guard the
DBP driver polls at step boundaries, the step watchdog its metric drain
feeds, ``retry_step`` behind the host stores' stage replay) and the
deterministic fault injector (``inject``: the chaos seam at the stores'
stage boundaries and the checkpoint writer). The quantized ring
all-reduce is not ported yet (``ROADMAP.md``, port Queue 1, item 6)."""
from .checkpoint import (
    latest_step,
    restore_checkpoint,
    restore_latest_verifiable,
    save_checkpoint,
)
from .compressed import (
    PACK_HEADER_BYTES,
    PackedKeys,
    dequantize_rows_np,
    min_index_dtype,
    pack_sorted_keys,
    quantize_rows_np,
    unpack_sorted_keys,
)
from .fault import PreemptionGuard, RetryExhausted, StepWatchdog, retry_step
from .inject import (
    NULL_INJECTOR,
    FaultInjector,
    InjectedFault,
    parse_fault_spec,
    resolve_fault_inject,
)

__all__ = [
    "latest_step",
    "restore_checkpoint",
    "restore_latest_verifiable",
    "save_checkpoint",
    "PACK_HEADER_BYTES",
    "PackedKeys",
    "dequantize_rows_np",
    "min_index_dtype",
    "pack_sorted_keys",
    "quantize_rows_np",
    "unpack_sorted_keys",
    "PreemptionGuard",
    "RetryExhausted",
    "StepWatchdog",
    "retry_step",
    "FaultInjector",
    "InjectedFault",
    "NULL_INJECTOR",
    "parse_fault_spec",
    "resolve_fault_inject",
]
