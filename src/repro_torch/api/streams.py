"""Host batch streams for a resolved Workload (``repro.api.streams``): the
one place that maps a workload to a synthetic input iterator.

- ``dlrm`` backbone: ``SyntheticRecsysStream`` (multi-table zipf CTR);
- sequential backbones (HSTU, FuXi): ``SyntheticLMStream``, zipf item-id
  sequences drawn from the first table's vocabulary, at the stream's
  default zipf exponent 1.1 (not ``cfg.zipf_a``), as JAX draws them;
- dense LMs: ``SyntheticLMStream`` over the vocabulary at the workload's
  sequence length, with its next-token ``labels``: the same batches as
  JAX's stream for a seed; an encoder-decoder's windows carry ``frames``
  too (``draw_frames``, JAX's draw bit for bit), a VLM's zero ``patches``
  and labels padded with -1 over the patch span ahead of the text's.

Streams are deterministic in ``(seed, batch index)``; ``start_step``
fast-forwards to any batch index exactly.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..data.synthetic import SyntheticLMStream, SyntheticRecsysStream


def draw_frames(seed: int, step: int, shape: Tuple[int, ...]) -> np.ndarray:
    """An encoder-decoder window's stub frames: normals times 0.02 in f32
    from ``np.random.default_rng((seed, step, 7))``, as JAX's stream draws
    them (one thread: ziggurat normals split across threads would give
    other bits)."""
    rng = np.random.default_rng((seed, step, 7))
    return rng.normal(size=shape).astype(np.float32) * 0.02


def resolve_stream(wl, seed: int = 0, *, start_step: int = 0) -> Iterator[dict]:
    """Infinite iterator of host batch dicts matching ``wl.batch_shapes``
    (plus ``raw_keys``, which clustering reads and the device never sees)."""
    cfg = wl.cfg
    if wl.bundle is not None:
        lm = SyntheticLMStream(cfg.vocab_size, wl.spec, wl.global_batch,
                               wl.batch_shapes["keys"][0][2], seed=seed)

        frames = wl.batch_shapes.get("frames")  # ((N, mb, n_frames, enc_d), f32)
        patches = wl.batch_shapes.get("patches")  # ((N, mb, n_positions, d), f32)

        def make(step):
            b = lm.make_batch(step)
            out = {"keys": b["keys"], "raw_keys": b["raw_tokens"], "labels": b["labels"]}
            if frames is not None:
                out["frames"] = draw_frames(seed, step, (wl.global_batch, *frames[0][2:]))
            if patches is not None:
                n_p = patches[0][2]
                out["labels"] = np.concatenate(
                    [np.full((wl.global_batch, n_p), -1, np.int32), b["labels"]], axis=1)
                out["patches"] = np.zeros((wl.global_batch, *patches[0][2:]), np.float32)
            return out
    elif cfg.backbone == "dlrm":
        stream = SyntheticRecsysStream(cfg, wl.spec, wl.global_batch, seed=seed,
                                       zipf_a=cfg.zipf_a)

        def make(step):
            b = stream.make_batch(step)
            return {"keys": b.keys, "dense": b.dense, "labels": b.labels,
                    "raw_keys": b.raw_keys}
    else:
        lm = SyntheticLMStream(cfg.tables[0].vocab_size, wl.spec,
                               wl.global_batch, cfg.seq_len, seed=seed)

        def make(step):
            b = lm.make_batch(step)
            return {"keys": b["keys"], "raw_keys": b["raw_tokens"]}

    def gen():
        step = start_step
        while True:
            yield make(step)
            step += 1

    return gen()
