"""Distributed-path pieces of the port (``repro.dist``): so far the host
codecs of the sparse data path."""
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
    "PACK_HEADER_BYTES",
    "PackedKeys",
    "dequantize_rows_np",
    "min_index_dtype",
    "pack_sorted_keys",
    "quantize_rows_np",
    "unpack_sorted_keys",
]
