"""Synthetic zipf request streams + closed/open-loop drivers.

Serving load is the same truncated power-law key distribution training
uses (``data/synthetic.SyntheticRecsysStream``), unrolled one request
per sample — so a serving replica sees exactly the popularity skew the
trained table saw, and the hot-cache hit rate under zipf traffic is an
apples-to-apples readout against the training-side cache.

Two drivers:

- :func:`run_closed_loop` — throughput mode: keep a bounded backlog in
  front of the router at all times and measure sustained QPS. This is
  the ``serve_qps_zipf`` bench cell.
- :func:`run_open_loop` — latency mode: arrivals are paced at a target
  QPS on an injectable clock/sleep, so per-request p50/p99 reflect the
  max-wait/max-batch coalescing policy rather than raw device speed.
  This is the ``serve_p99`` bench cell.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..data.synthetic import SyntheticRecsysStream
from .router import ServeRouter


def synthetic_requests(
    workload, n: int, *, zipf_a: Optional[float] = None, seed: int = 0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Materialize ``n`` (keys (F,), dense (num_dense,)) request tuples
    drawn from the workload's synthetic recsys distribution."""
    cfg = workload.cfg
    a = cfg.zipf_a if zipf_a is None else float(zipf_a)
    # One stream batch per window of requests; batch size just controls
    # how many samples each pull yields.
    per_pull = max(32, min(n, 512))
    stream = SyntheticRecsysStream(cfg, workload.spec, per_pull,
                                   zipf_a=a, seed=seed)
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    step = 0
    while len(out) < n:
        batch = stream.make_batch(step)
        step += 1
        for i in range(batch.keys.shape[0]):
            out.append((batch.keys[i], batch.dense[i]))
            if len(out) == n:
                break
    return out


def run_closed_loop(
    router: ServeRouter,
    requests: List[Tuple[np.ndarray, np.ndarray]],
    *,
    backlog: Optional[int] = None,
    clock: Callable[[], float] = time.perf_counter,
) -> Dict[str, float]:
    """Feed the router as fast as it drains (bounded backlog), measure
    sustained QPS over the whole stream."""
    if backlog is None:
        backlog = 4 * router.batcher.max_batch
    n = len(requests)
    t0 = clock()
    it = iter(requests)
    fed = 0
    while fed < n or router.batcher.pending():
        while fed < n and router.batcher.pending() < backlog:
            keys, dense = next(it)
            router.submit(keys, dense)
            fed += 1
        router.pump(force=fed >= n)
    wall = clock() - t0
    out = router.metrics()
    out["requests"] = float(n)
    out["wall_s"] = round(wall, 6)
    out["qps"] = round(n / wall, 2) if wall > 0 else 0.0
    return out


def run_open_loop(
    router: ServeRouter,
    requests: List[Tuple[np.ndarray, np.ndarray]],
    qps: float,
    *,
    clock: Callable[[], float] = time.perf_counter,
    sleep: Callable[[float], None] = time.sleep,
) -> Dict[str, float]:
    """Pace arrivals at ``qps`` (never sleeping when behind schedule, so
    overload shows up as queueing latency, not silent deceleration)."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    period = 1.0 / qps
    t0 = clock()
    next_t = t0
    for keys, dense in requests:
        now = clock()
        if now < next_t:
            sleep(next_t - now)
        router.submit(keys, dense)
        next_t += period
        router.pump()
    router.drain()
    wall = clock() - t0
    out = router.metrics()
    out["requests"] = float(len(requests))
    out["qps_target"] = round(qps, 2)
    out["wall_s"] = round(wall, 6)
    out["qps"] = round(len(requests) / wall, 2) if wall > 0 else 0.0
    return out


__all__ = ["synthetic_requests", "run_closed_loop", "run_open_loop"]
