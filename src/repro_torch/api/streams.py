"""Host batch streams for a resolved Workload (``repro.api.streams``, DLRM
branch): the one place that maps a workload to a synthetic input iterator.

Streams are deterministic in ``(seed, batch index)``; ``start_step``
fast-forwards to any batch index exactly.
"""
from __future__ import annotations

from typing import Iterator

from ..data.synthetic import SyntheticRecsysStream


def resolve_stream(wl, seed: int = 0, *, start_step: int = 0) -> Iterator[dict]:
    """Infinite iterator of host batch dicts matching ``wl.batch_shapes``
    (plus ``raw_keys``, which clustering reads and the device never sees)."""
    if wl.cfg.backbone != "dlrm":
        raise NotImplementedError(f"backbone {wl.cfg.backbone!r} is not ported")
    stream = SyntheticRecsysStream(wl.cfg, wl.spec, wl.global_batch, seed=seed,
                                   zipf_a=wl.cfg.zipf_a)

    def gen():
        step = start_step
        while True:
            b = stream.make_batch(step)
            yield {"keys": b.keys, "dense": b.dense, "labels": b.labels,
                   "raw_keys": b.raw_keys}
            step += 1

    return gen()
