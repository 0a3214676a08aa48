#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``src/repro_torch``).

Drives the port's main path once on one NVIDIA GPU and holds every
hand-written kernel on it against its plain PyTorch version:

1. environment: the card's name and power limit, torch and CUDA versions,
   TF32 switched off for matmuls and convolutions;
2. build: compiles every kernel from ``src/repro_torch/csrc`` with nvcc;
3. kernels: ``embedding_gather`` against ``gather_rows_ref``, bit for bit,
   at edge cases and at the four gathers of a full-width ``dlrm-ctr``
   serving window (the first one on the 29.19 GB table), each timed beside
   its plain version, ``torch.index_select`` and its bandwidth bound;
4. main path: ``Session.from_arch("dlrm-ctr").serve_embeddings(head="dlrm")``
   over 4,096 requests in windows of 512 from the 57,012,000-row device
   table, ``check_exact=True``, with the gather's launches counted;
5. a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.

Every phase prints one JSON line. Nothing is caught: any failure exits
non-zero. Run from the repo root: ``python3 chip_smoke.py``
(``--profile`` adds a ``torch.profiler`` pass over the serving path).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

ARCH = "dlrm-ctr"
MAX_BATCH = 512
N_REQUESTS = 4096
TIMED_RUNS = 30
KERNEL_SOURCE = "src/repro_torch/csrc/embedding_gather.cu"
KERNEL_REPLACES = "src/repro/kernels/embedding_gather.py:35"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def peak_bytes_per_s(name: str) -> float:
    """Published device-memory bandwidth of the card nvidia-smi names
    (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name:
        if "PCIe" in name:
            return 2.0e12
        if "NVL" in name:
            return 3.9e12
        return 3.35e12  # SXM, "NVIDIA H100 80GB HBM3"
    raise SystemExit(f"chip_smoke: no bandwidth figure for {name!r}")


def time_ms(torch, fn, flush) -> float:
    """Median device time of ``fn`` over TIMED_RUNS launches, each timed
    alone with CUDA events after a write of ``flush`` evicts the 50 MB L2
    (the main path finds the master table cold). A ~100 us spin after the
    flush keeps the card busy until ``fn`` is queued, so the events time
    the device work and not the host's launch overhead."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def gather_bytes(torch, src, idx) -> int:
    """Bytes the gather must move for this data: each distinct valid row
    read once, every output row written once, every index read once."""
    valid = idx[(idx >= 0) & (idx < src.shape[0])]
    distinct = int(torch.unique(valid).numel())
    row = src.shape[1] * src.element_size()
    return distinct * row + idx.numel() * row + idx.numel() * idx.element_size()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--profile", action="store_true",
                   help="add a torch.profiler pass over the serving path")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.api import InferenceStrategy, Session
    from repro_torch.core.embedding.engine import LookupPlan
    from repro_torch.core.embedding.routing import SENTINEL, sorted_lookup
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.launch.build import resolve
    from repro_torch.serve import synthetic_requests

    dev = torch.device("cuda")

    # -- 1. environment ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peak = peak_bytes_per_s(name)
    emit("env", nvidia_smi=smi[0], device=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         peak_bytes_per_s=peak)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         sources=list(build.SOURCES),
         ptxas={k: [ln for ln in v["ptxas"].splitlines() if "registers" in ln]
                for k, v in build.build_log.items()})

    # -- 3. kernel against its plain version ------------------------------
    worst = 0.0

    def check(label, src, idx):
        nonlocal worst
        got = eg.embedding_gather(src, idx)
        want = ref.gather_rows_ref(src, idx)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not torch.equal(got, want):
            raise SystemExit(f"embedding_gather != plain at {label}: {err}")
        worst = max(worst, err)
        return got

    g = torch.Generator(dev).manual_seed(0)
    edge = []
    for rows, d in ((1000, 1), (1000, 33), (1000, 128)):
        t = torch.empty((rows, d), device=dev).normal_(generator=g)
        for n in (0, 1, 777):
            idx = torch.randint(0, rows, (n,), device=dev, generator=g,
                                dtype=torch.int32)
            if n > 1:
                idx[::5] = rows
                idx[1::7] = SENTINEL
                idx[2::9] = -1
            check(f"D={d} n={n}", t, idx)
            edge.append(f"D={d},n={n}")
        flat = torch.empty(rows * d + 1, device=dev).normal_(generator=g)
        misaligned = flat[1:].view(rows, d)  # 4 bytes off 16-byte alignment
        check(f"misaligned D={d}", misaligned,
              torch.randint(-2, rows + 2, (513,), device=dev, generator=g,
                            dtype=torch.int32))
        edge.append(f"D={d},misaligned")
    emit("kernel_edges", cases=edge, exact=True)

    sess = Session.from_arch(ARCH, bucket_slack=1.5, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, table = sess.weights()
    torch.cuda.synchronize()
    emit("init", seconds=round(time.perf_counter() - t0, 3),
         table_rows=table.rows.shape[0], dim=table.rows.shape[1],
         table_gb=round(table.rows.numel() * 4 / 1e9, 3))

    # the four gathers of one full-width serving window, on real requests
    wl = resolve(ARCH, device=dev, npcfg=InferenceStrategy().configure(
        sess.workload.npcfg), global_batch=MAX_BATCH)
    reqs = synthetic_requests(wl, MAX_BATCH, seed=0)
    keys = torch.as_tensor(np.stack([k for k, _ in reqs]),
                           device=dev).reshape(1, MAX_BATCH, -1)
    with torch.inference_mode():
        window = wl.engine.route_window(keys, 1)
        plan = LookupPlan(*(x[0] for x in window.plans))
        bkeys = window.buffer_keys
        master_idx = torch.where(bkeys != SENTINEL, bkeys, wl.spec.padded_rows)
        buf_rows = check("retrieve", table.rows, master_idx)
        buf_idx = sorted_lookup(bkeys, plan.recv_keys.reshape(-1))
        served = check("serve-from-buffer", buf_rows, buf_idx)
        unique_emb = check("assemble-1", served, plan.slot_of_unique)
        check("assemble-2", unique_emb, plan.inverse)
    cases = [("retrieve", table.rows, master_idx),
             ("serve-from-buffer", buf_rows, buf_idx),
             ("assemble-1", served, plan.slot_of_unique),
             ("assemble-2", unique_emb, plan.inverse)]

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    shapes = []
    for label, src, idx in cases:
        lib_idx = idx.clamp(0, src.shape[0] - 1).long()
        nbytes = gather_bytes(torch, src, idx)
        shapes.append({
            "gather": label, "src_rows": src.shape[0], "n": idx.numel(),
            "dim": src.shape[1], "bytes": nbytes,
            "ms": time_ms(torch, lambda: eg.embedding_gather(src, idx), flush),
            "plain_ms": time_ms(torch, lambda: ref.gather_rows_ref(src, idx), flush),
            "library_ms": time_ms(
                torch, lambda: torch.index_select(src, 0, lib_idx), flush),
            "bound_ms": nbytes / peak * 1e3,
        })
        emit("kernel_shape", **shapes[-1], exact=True)
    del flush

    # -- 4. main path -----------------------------------------------------
    # one unchecked warm-up pass first: the counted run below is then not
    # charged with the first calls' CUDA and cuBLAS set-up
    sess.serve_embeddings(num_requests=2 * MAX_BATCH, max_batch=MAX_BATCH,
                          head="dlrm")
    torch.cuda.synchronize()
    eg.launches = 0
    t0 = time.perf_counter()
    rep = sess.serve_embeddings(num_requests=N_REQUESTS, max_batch=MAX_BATCH,
                                head="dlrm", check_exact=True)
    wall = time.perf_counter() - t0
    launches = eg.launches
    s = rep.summary
    windows = int(s["windows"])
    chunks = -(-N_REQUESTS // MAX_BATCH)
    emit("serve", arch=ARCH, head="dlrm", requests=N_REQUESTS,
         max_batch=MAX_BATCH, windows=windows, qps=s["qps"],
         latency_p50_ms=s["latency_p50_ms"], latency_p99_ms=s["latency_p99_ms"],
         serve_wall_s=s["wall_s"], total_wall_s=round(wall, 3),
         exact=s["exact"], max_abs_diff=s["max_abs_diff"],
         gather_launches=launches, ground_truth_chunks=chunks,
         table_device=str(table.rows.device), table_rows=table.rows.shape[0],
         table_gb=round(table.rows.numel() * 4 / 1e9, 3),
         max_memory_allocated_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    if s["exact"] != 1:
        raise SystemExit(f"served logits differ from the master ground truth: {s}")
    if table.rows.device.type != "cuda" or table.rows.shape[0] != 57_012_000:
        raise SystemExit("the dlrm-ctr master is not the full table on the card")
    if launches != 4 * windows + 3 * chunks:
        raise SystemExit(f"gather launches {launches} != 4 x {windows} windows "
                         f"+ 3 x {chunks} ground-truth chunks")
    if rep.results.shape != (N_REQUESTS,) or not bool(
            torch.isfinite(torch.from_numpy(rep.results)).all()):
        raise SystemExit("served logits are not finite of shape (requests,)")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.serve.batcher import WindowBatcher
        from repro_torch.serve.router import ServeRouter

        # host wall time by serving step, unprofiled: the methods are
        # wrapped here for this pass only and restored after it
        spent = {}
        wrapped = [(WindowBatcher, "submit"), (WindowBatcher, "next_window"),
                   (ServeRouter, "_dispatch")]
        originals = [getattr(cls, m) for cls, m in wrapped]

        def timed(fn, key):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
            return run

        for (cls, m), fn in zip(wrapped, originals):
            setattr(cls, m, timed(fn, m))
        try:
            t0 = time.perf_counter()
            sess.serve_embeddings(num_requests=N_REQUESTS, max_batch=MAX_BATCH,
                                  head="dlrm")
            span = time.perf_counter() - t0
        finally:
            for (cls, m), fn in zip(wrapped, originals):
                setattr(cls, m, fn)
        emit("host_breakdown", requests=N_REQUESTS, wall_ms=round(span * 1e3, 3),
             **{f"{k}_ms": round(v * 1e3, 3) for k, v in spent.items()})

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.serve_embeddings(num_requests=N_REQUESTS, max_batch=MAX_BATCH,
                                  head="dlrm")
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        events = prof.key_averages()
        device_us = sum(e.self_device_time_total for e in events)
        host_ops_us = sum(e.self_cpu_time_total for e in events)
        by_device = sorted(events, key=lambda e: -e.self_device_time_total)
        by_host = sorted(events, key=lambda e: -e.self_cpu_time_total)
        emit("profile", requests=N_REQUESTS, wall_ms=round(span * 1e3, 3),
             device_busy_ms=round(device_us / 1e3, 3),
             device_idle_share=round(1 - device_us / 1e3 / (span * 1e3), 4),
             host_torch_ops_ms=round(host_ops_us / 1e3, 3),
             top_device=[{"name": e.key[:70], "count": e.count,
                          "ms": round(e.self_device_time_total / 1e3, 4)}
                         for e in by_device[:10]],
             top_host=[{"name": e.key[:70], "count": e.count,
                        "ms": round(e.self_cpu_time_total / 1e3, 4)}
                       for e in by_host[:10]])

    # -- 5. kernels line and the result ------------------------------------
    kernels = [{
        "name": "embedding_gather", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": worst,
        "ms": sum(x["ms"] for x in shapes),
        "plain_ms": sum(x["plain_ms"] for x in shapes),
        "bound_ms": sum(x["bound_ms"] for x in shapes),
        "bound_by": "bytes",
        "library_ms": sum(x["library_ms"] for x in shapes),
        "per_window_of": [x["gather"] for x in shapes],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
