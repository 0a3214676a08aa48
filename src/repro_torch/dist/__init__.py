"""Distributed-path pieces of the port (``repro.dist``): atomic manifest
checkpoints (``checkpoint``) and the host codecs of the sparse data path
(``compressed``). The fault policies and the fault injector (the
preemption guard, the step watchdog, ``retry_step``) are not ported yet
(``ROADMAP.md``, port Queue 1, item 3b), nor is the quantized ring
all-reduce (item 6)."""
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
]
