#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``src/repro_torch``).

Drives the port's main paths once on one NVIDIA GPU and holds every
hand-written kernel on it against its plain PyTorch version:

1. environment: the card's name and power limit, torch and CUDA versions,
   TF32 switched off for matmuls and convolutions;
2. build: compiles every kernel from ``src/repro_torch/csrc`` with nvcc, one
   process per source, all at once;
3. kernel edges: ``embedding_gather``, ``segment_rowsum``, ``buffer_sync``
   and ``embedding_scatter`` against their plain versions at edge cases
   (empty, one segment, drop ids and sentinels, negative sources, D in
   {1, 33, 128}, a view off 16-byte alignment), bit for bit where the sums
   are exact, and the same bits on two runs;
4. a full-width ``dlrm-ctr`` training session (``mode="nestpipe"``,
   ``global_batch=8192``, N = 4, ``bucket_slack=1.5``) on the 29.19 GB
   table: one warm-up step, then two steps whose kernel calls are captured,
   and every captured call checked against its plain version and timed
   beside the plain version, one PyTorch library call where there is one,
   and its bandwidth bound;
5. main path, training: ``train(8)`` with every launch counted; finite
   losses, no routing overflow, the master still full on the card, rows of
   window 0 changed;
6. main path, serving: the trained weights served from the same session,
   4,096 requests in windows of 512, ``check_exact=True``, gather launches
   counted (and the four gathers of one serving window timed first);
7. consistency at the reduced ``dlrm-ctr``: nestpipe = serial = the naive
   reference trainer within 1e-5 over 6 steps, and async diverges;
8. a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.

Every phase prints one JSON line. Nothing is caught: any failure exits
non-zero. Run from the repo root: ``python3 chip_smoke.py`` (``--profile``
adds a host breakdown and a ``torch.profiler`` pass over 4 training steps
and over the serving path).
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
TRAIN_BATCH = 8192
N_MICRO = 4
SLACK = 1.5
TRAIN_STEPS = 8
MAX_BATCH = 512
N_REQUESTS = 4096
TIMED_RUNS = 30
CONSISTENCY_STEPS = 6
KERNELS = {  # name -> (source, the Pallas kernel it replaces)
    "embedding_gather": ("src/repro_torch/csrc/embedding_gather.cu",
                         "src/repro/kernels/embedding_gather.py:35"),
    "segment_rowsum": ("src/repro_torch/csrc/segment_rowsum.cu",
                       "src/repro/kernels/segment_rowsum.py:52"),
    "buffer_sync": ("src/repro_torch/csrc/buffer_sync.cu",
                    "src/repro/kernels/buffer_sync.py:32"),
    # no Pallas kernel: the XLA scatter of EmbeddingEngine.writeback
    "embedding_scatter": ("src/repro_torch/csrc/embedding_scatter.cu",
                          "src/repro/core/embedding/engine.py:510"),
}


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


def segment_bytes(grads, ids, segments) -> int:
    """Each in-range grads row read once, every id read once, every output
    row written once."""
    n_in = int(((ids >= 0) & (ids < segments)).sum())
    row = grads.shape[1] * 4
    return n_in * row + ids.numel() * 4 + segments * row


def sync_bytes(active, prefetch, src) -> int:
    """Per prefetch slot: one row and accumulator read (active or
    prefetch), one row and accumulator written, one index read."""
    kp, d = prefetch.shape
    return kp * (2 * (d * 4 + 4) + 4)


def scatter_bytes(table, idx) -> int:
    """Each valid slot's row and accumulator read and written once, every
    index read once."""
    n_valid = int(((idx >= 0) & (idx < table.shape[0])).sum())
    return n_valid * 2 * (table.shape[1] * 4 + 4) + idx.numel() * 4


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--profile", action="store_true",
                   help="add a host breakdown and a torch.profiler pass over "
                        "training and serving")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.api import InferenceStrategy, Session, resolve_stream
    from repro_torch.core.consistency import build_reference_step
    from repro_torch.core.embedding.engine import LookupPlan
    from repro_torch.core.embedding.routing import SENTINEL, sorted_lookup
    from repro_torch.data.pipeline import make_cluster_transform, stage_to_device
    from repro_torch.kernels import build, dispatch, ref
    from repro_torch.kernels import buffer_sync as bs
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import embedding_scatter as es
    from repro_torch.kernels import segment_rowsum as sr
    from repro_torch.launch.build import resolve
    from repro_torch.models.dlrm import make_dlrm_loss_fn
    from repro_torch.serve import synthetic_requests
    from repro_torch.train import clone_state, constant_lr

    dev = torch.device("cuda")
    mods = {"embedding_gather": eg, "segment_rowsum": sr, "buffer_sync": bs,
            "embedding_scatter": es}

    def reset_counts():
        for m in mods.values():
            m.launches = 0

    def counts():
        return {k: m.launches for k, m in mods.items()}

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
         ptxas={k: [ln.strip() for ln in v["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in build.build_log.items()})

    # -- 3. kernels against their plain versions at edge cases ------------
    worst = {k: 0.0 for k in mods}

    def record(kernel, got, want, label, tol=None):
        """Bit for bit, or within ``tol`` (a tensor of per-element bounds)."""
        for a, b in zip(got, want):
            err = float((a - b).abs().max()) if a.numel() else 0.0
            if tol is None and not torch.equal(a, b):
                raise SystemExit(f"{kernel} != plain at {label}: {err}")
            if tol is not None and not bool(((a - b).abs() <= tol).all()):
                raise SystemExit(f"{kernel} beyond its bound at {label}: {err}")
            worst[kernel] = max(worst[kernel], err)

    def check_gather(label, src, idx):
        got = eg.embedding_gather(src, idx)
        record("embedding_gather", [got], [ref.gather_rows_ref(src, idx)], label)
        return got

    def check_segment(label, grads, ids, segments, integer):
        got = sr.segment_rowsum(grads, ids, segments)
        again = sr.segment_rowsum(grads, ids, segments)
        if not torch.equal(got, again):
            raise SystemExit(f"segment_rowsum not deterministic at {label}")
        # The card's plain version adds with atomics, in another order: exact
        # on integer grads; otherwise within 1e-6 of each output's sum of
        # magnitudes plus 1e-6 (reordering an f32 sum of n terms moves it by
        # about sqrt(n) * 6e-8 of that sum, (n-1) * 6e-8 at worst).
        tol = None if integer else 1e-6 * ref.segment_rowsum_ref(
            grads.abs(), ids, segments) + 1e-6
        record("segment_rowsum", [got], [ref.segment_rowsum_ref(grads, ids, segments)],
               label, tol)
        if ids.numel() <= 4096:  # the CPU plain version adds in input order
            record("segment_rowsum", [got.cpu()],
                   [ref.segment_rowsum_ref(grads.cpu(), ids.cpu(), segments)], label)
        return got

    def check_sync(label, *a):
        got = bs.buffer_sync(*a)
        again = bs.buffer_sync(*a)
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise SystemExit(f"buffer_sync not deterministic at {label}")
        record("buffer_sync", got, ref.buffer_sync_ref(*a), label)
        return got

    def check_scatter(label, table, table_accum, idx, rows, accum):
        got, got_acc = table.clone(), table_accum.clone()
        want, want_acc = table.clone(), table_accum.clone()
        es.embedding_scatter(got, got_acc, idx, rows, accum)
        ref.embedding_scatter_ref(want, want_acc, idx, rows, accum)
        record("embedding_scatter", [got, got_acc], [want, want_acc], label)

    def misaligned(t):
        flat = torch.cat([t.new_zeros(1), t.reshape(-1)])
        return flat[1:].view(t.shape)  # 4 bytes off 16-byte alignment

    g = torch.Generator(dev).manual_seed(0)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), device=dev, generator=g, dtype=torch.int32)

    edge = []
    for d in (1, 33, 128):
        t = torch.empty((1000, d), device=dev).normal_(generator=g)
        for n in (0, 1, 777):
            idx = randint(0, 1000, n)
            if n > 1:
                idx[::5] = 1000
                idx[1::7] = SENTINEL
                idx[2::9] = -1
            check_gather(f"D={d} n={n}", t, idx)
            edge.append(f"gather D={d},n={n}")
        check_gather(f"misaligned D={d}", misaligned(t), randint(-2, 1002, 513))
        edge.append(f"gather D={d},misaligned")
        for n, s in ((0, 7), (300, 1), (2000, 64), (2000, 700)):
            ids = randint(0, s, n)  # unsorted, with repeats
            if n:
                ids[::6] = s
                ids[1::11] = SENTINEL
                ids[2::13] = -1
            for integer in (True, False):
                grads = torch.empty((n, d), device=dev).normal_(generator=g)
                if integer:
                    grads = torch.round(grads * 8)
                check_segment(f"D={d} L={n} S={s}", grads, ids, s, integer)
                check_segment(f"misaligned D={d} L={n} S={s}", misaligned(grads),
                              ids, s, integer)
            edge.append(f"segment_rowsum D={d},L={n},S={s}")
        for ka, kp in ((1, 5), (600, 800), (800, 0)):
            act = torch.empty((ka, d), device=dev).normal_(generator=g)
            pre = torch.empty((kp, d), device=dev).normal_(generator=g)
            aa = torch.rand(ka, device=dev, generator=g)
            pa = torch.rand(kp, device=dev, generator=g)
            src = randint(0, ka, kp)
            if kp:
                src[::3] = ka
                src[1::7] = SENTINEL
                src[2::9] = -1
            check_sync(f"D={d} Ka={ka} Kp={kp}", act, aa, pre, pa, src)
            check_sync(f"misaligned D={d} Ka={ka} Kp={kp}", misaligned(act), aa,
                       misaligned(pre), pa, src)
            edge.append(f"buffer_sync D={d},Ka={ka},Kp={kp}")
        for r, n in ((900, 0), (900, 640)):
            table = torch.empty((r, d), device=dev).normal_(generator=g)
            idx = torch.randperm(r, device=dev, generator=g)[:n].to(torch.int32)
            if n:
                idx[::4] = r
                idx[1::9] = SENTINEL
                idx[2::10] = -1
            rows = torch.empty((n, d), device=dev).normal_(generator=g)
            check_scatter(f"D={d} R={r} n={n}", table, torch.rand(r, device=dev),
                          idx, rows, torch.rand(n, device=dev))
            check_scatter(f"misaligned D={d} R={r} n={n}", misaligned(table),
                          torch.rand(r, device=dev), idx, misaligned(rows),
                          torch.rand(n, device=dev))
            edge.append(f"embedding_scatter D={d},R={r},n={n}")
    torch.cuda.synchronize()
    emit("kernel_edges", cases=edge, max_abs_err=worst,
         exact="bit-exact, except segment_rowsum on normal grads against the "
               "card's atomic index_add_: within 1e-6 of each output's sum of "
               "magnitudes + 1e-6 (bit-exact against the CPU plain version)")

    # -- 4. the full-width training session -------------------------------
    sess = Session.from_arch(ARCH, mode="nestpipe", global_batch=TRAIN_BATCH,
                             n_micro=N_MICRO, bucket_slack=SLACK, seed=0)
    wl = sess.workload
    dims = wl.engine.dims(wl.batch_shapes["keys"][0][1:], N_MICRO)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = sess.state
    torch.cuda.synchronize()
    emit("init", seconds=round(time.perf_counter() - t0, 3),
         table_rows=state.table.rows.shape[0], dim=state.table.rows.shape[1],
         table_gb=round(state.table.rows.numel() * 4 / 1e9, 3),
         dims={"L": dims.l_local, "U": dims.u_max, "C": dims.cap,
               "K": dims.buffer_cap, "N": dims.n_micro})

    # one unchecked warm-up step: the counted run below is then not charged
    # with the first calls' CUDA and cuBLAS set-up
    sess.train(1)
    torch.cuda.synchronize()

    # two steps with every kernel call's inputs captured (the first call of
    # each kind per step); the master is kept by reference, not copied
    captured = {"gather": [], "segment": [], "sync": [], "scatter": []}
    real = {k: getattr(dispatch, k) for k in
            ("gather_rows", "segment_rowsum", "buffer_sync", "scatter_rows")}
    master = state.table

    def keep(t):
        return t if t.data_ptr() in (master.rows.data_ptr(),
                                     master.accum.data_ptr()) else t.clone()

    def capture(kind, fn, limit):
        def run(*a):
            if len(captured[kind]) < limit:
                captured[kind].append(tuple(keep(x) if torch.is_tensor(x) else x
                                            for x in a))
            return fn(*a)
        return run

    # gathers: retrieve 0, retrieve 1 (queued ahead of window 0), then
    # window 0's 3 per micro-batch
    dispatch.gather_rows = capture("gather", real["gather_rows"], 14)
    dispatch.segment_rowsum = capture("segment", real["segment_rowsum"], 5)
    dispatch.buffer_sync = capture("sync", real["buffer_sync"], 1)
    dispatch.scatter_rows = capture("scatter", real["scatter_rows"], 1)
    try:
        sess.train(2)
    finally:
        for k, fn in real.items():
            setattr(dispatch, k, fn)
    torch.cuda.synchronize()
    master = sess.state.table
    if [len(v) for v in captured.values()] != [14, 5, 1, 1]:
        raise SystemExit(f"capture saw {[len(v) for v in captured.values()]} calls")
    captured["gather"] = captured["gather"][:1] + captured["gather"][2:]

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    shapes = {k: [] for k in mods}

    def timed(kernel, label, nbytes, fn, plain, library, **extra):
        row = {"kernel": kernel, "call": label, **extra, "bytes": nbytes,
               "ms": time_ms(torch, fn, flush),
               "plain_ms": time_ms(torch, plain, flush),
               "library_ms": time_ms(torch, library, flush) if library else None,
               "bound_ms": nbytes / peak * 1e3}
        shapes[kernel].append(row)
        emit("kernel_shape", path="train", **row)

    gather_labels = ["retrieve"] + [f"mb{i}-{part}" for i in range(N_MICRO)
                                    for part in ("serve", "assemble-1", "assemble-2")]
    for label, (src, idx) in zip(gather_labels, captured["gather"]):
        check_gather(label, src, idx)
        lib_idx = idx.clamp(0, src.shape[0] - 1).long()
        timed("embedding_gather", label, gather_bytes(torch, src, idx),
              lambda: eg.embedding_gather(src, idx),
              lambda: ref.gather_rows_ref(src, idx),
              lambda: torch.index_select(src, 0, lib_idx),
              src_rows=src.shape[0], n=idx.numel(), dim=src.shape[1])

    seg_labels = [f"grads_to_owner-mb{i}" for i in range(N_MICRO)] + ["window-to-buffer"]
    for label, (grads, ids, segments) in zip(seg_labels, captured["segment"]):
        check_segment(label, grads, ids, segments, integer=False)
        integral = torch.randint(-8, 8, grads.shape, device=dev, generator=g,
                                 dtype=torch.float32)
        check_segment(label + "-integer", integral, ids, segments, integer=True)
        kept = (ids >= 0) & (ids < segments)
        lib_ids, lib_grads = ids[kept].long(), grads[kept]
        run_counts = torch.bincount(lib_ids, minlength=segments)
        timed("segment_rowsum", label, segment_bytes(grads, ids, segments),
              lambda: sr.segment_rowsum(grads, ids, segments),
              lambda: ref.segment_rowsum_ref(grads, ids, segments),
              lambda: torch.zeros((segments, grads.shape[1]), device=dev)
              .index_add_(0, lib_ids, lib_grads),
              L=ids.numel(), S=segments, dim=grads.shape[1],
              in_range=lib_ids.numel(), longest_run=int(run_counts.max()),
              library_call="index_add_ of the in-range rows only, "
              "selected beforehand")

    (act, aa, pre, pa, src), = captured["sync"]
    check_sync("sync", act, aa, pre, pa, src)
    timed("buffer_sync", "sync", sync_bytes(act, pre, src),
          lambda: bs.buffer_sync(act, aa, pre, pa, src),
          lambda: ref.buffer_sync_ref(act, aa, pre, pa, src), None,
          Ka=act.shape[0], Kp=pre.shape[0], dim=pre.shape[1],
          hits=int((src < act.shape[0]).sum()))

    (_, _, idx, rows, accum), = captured["scatter"]
    # correctness at this call's n and D on a K-row stand-in (the write
    # pattern of the real master cannot be compared against a copy of it)
    valid = (idx >= 0) & (idx < master.rows.shape[0])
    k = idx.numel()
    proxy_idx = torch.where(valid, torch.randperm(k, device=dev, generator=g)
                            .to(torch.int32), k + 7)
    check_scatter("writeback-standin", torch.randn((k, rows.shape[1]), device=dev),
                  torch.rand(k, device=dev), proxy_idx, rows, accum)
    # timing on the real master, writing back the rows it holds now: the
    # write is real and leaves the master unchanged
    cur_rows = ref.gather_rows_ref(master.rows, idx)
    cur_acc = torch.where(valid, master.accum[idx.clamp(0, master.rows.shape[0] - 1)
                                             .long()], 0.0)
    lib_dst = idx[valid].long()
    lib_rows = cur_rows[valid]
    timed("embedding_scatter", "writeback", scatter_bytes(master.rows, idx),
          lambda: es.embedding_scatter(master.rows, master.accum, idx, cur_rows,
                                       cur_acc),
          lambda: ref.embedding_scatter_ref(master.rows, master.accum, idx,
                                            cur_rows, cur_acc),
          lambda: master.rows.index_copy_(0, lib_dst, lib_rows),
          table_rows=master.rows.shape[0], n=k, valid=int(valid.sum()),
          dim=rows.shape[1], library_call="index_copy_ of the rows only, "
          "valid indices selected beforehand")
    if not torch.equal(ref.gather_rows_ref(master.rows, idx), cur_rows):
        raise SystemExit("the write-back timing changed the master")
    del captured, cur_rows, cur_acc, lib_rows
    torch.cuda.synchronize()

    # -- 5. main path: training --------------------------------------------
    # rows of the first counted window, before and after
    stream = resolve_stream(wl, sess.seed, start_step=int(sess.state.step))
    first = make_cluster_transform(N_MICRO, wl.npcfg.clustering)(next(stream))
    keys0 = torch.as_tensor(first["keys"], device=dev)
    bkeys = wl.engine.route_window(keys0, N_MICRO).buffer_keys
    bkeys = bkeys[bkeys != SENTINEL]
    sample = bkeys[torch.randperm(bkeys.numel(), device=dev, generator=g)[:4096]].long()
    rows_before = sess.state.table.rows[sample].clone()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rep = sess.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = counts()
    s = rep.summary
    table = sess.state.table
    changed = float((table.rows[sample] != rows_before).any(-1).float().mean())
    emit("train", arch=ARCH, mode="nestpipe", global_batch=TRAIN_BATCH,
         n_micro=N_MICRO, bucket_slack=SLACK, steps=TRAIN_STEPS,
         losses=rep.stats.losses, overflow_max=s["overflow_max"],
         samples_per_s=TRAIN_BATCH * TRAIN_STEPS / wall, wall_s=wall,
         step_ms=[x * 1e3 for x in rep.stats.step_times],
         step_p50_ms=s["p50_step_s"] * 1e3, step_p99_ms=s["p99_step_s"] * 1e3,
         mean_input_wait_ms=s["mean_input_wait_s"] * 1e3,
         stage_host_ms={k: s[k] for k in ("plan_ms", "retrieve_ms", "commit_ms")},
         launches=train_launches, window0_rows_changed=changed,
         table_device=str(table.rows.device), table_rows=table.rows.shape[0],
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not all(np.isfinite(rep.stats.losses)) or len(rep.stats.losses) != TRAIN_STEPS:
        raise SystemExit(f"training losses are not {TRAIN_STEPS} finite values")
    if s["overflow_max"] != 0:
        raise SystemExit(f"routing overflowed during training: {s['overflow_max']}")
    if table.rows.device.type != "cuda" or table.rows.shape[0] != 57_012_000:
        raise SystemExit("the dlrm-ctr master is not the full table on the card")
    if changed < 0.99:
        raise SystemExit(f"only {changed:.4f} of window 0's sampled rows changed")
    want = {"embedding_gather": (1 + 3 * N_MICRO) * TRAIN_STEPS,
            "segment_rowsum": (N_MICRO + 1) * TRAIN_STEPS,
            "buffer_sync": TRAIN_STEPS - 1, "embedding_scatter": TRAIN_STEPS}
    if train_launches != want:
        raise SystemExit(f"training launches {train_launches} != {want}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.core.dbp import pipeline as dbp
        from repro_torch.core.store import DeviceStore, Prefetcher

        spent = {}

        def clocked(fn, key):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
            return run

        fns = sess.fns
        wrapped = [(Prefetcher, "fill"), (DeviceStore, "commit"),
                   (dbp._MetricsDrain, "drain")]
        originals = [getattr(c, m) for c, m in wrapped]
        for (c, m), fn in zip(wrapped, originals):
            setattr(c, m, clocked(fn, f"{c.__name__}.{m}"))
        sess._fns = fns._replace(
            window_step=clocked(fns.window_step, "window_step"),
            sync_buffers=clocked(fns.sync_buffers, "sync_buffers"))
        try:
            t0 = time.perf_counter()
            sess.train(4)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        finally:
            for (c, m), fn in zip(wrapped, originals):
                setattr(c, m, fn)
            sess._fns = fns
        # what the data thread does per batch, alone: draw it, cluster it
        gen = resolve_stream(wl, sess.seed, start_step=1000)
        transform = make_cluster_transform(N_MICRO, wl.npcfg.clustering)
        batch_ms = []
        for _ in range(3):
            t = time.perf_counter()
            transform(next(gen))
            batch_ms.append((time.perf_counter() - t) * 1e3)
        emit("train_host_breakdown", steps=4, wall_ms=span * 1e3,
             **{f"{k}_ms": v * 1e3 for k, v in spent.items()},
             host_batch_ms=statistics.median(batch_ms))

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.train(4)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "train_profile", span, steps=4)

    # -- 6. main path: serving the trained weights --------------------------
    model, table = sess.weights()
    swl = resolve(ARCH, device=dev, mode="serve", npcfg=InferenceStrategy()
                  .configure(wl.npcfg), global_batch=MAX_BATCH)
    reqs = synthetic_requests(swl, MAX_BATCH, seed=0)
    keys = torch.as_tensor(np.stack([k for k, _ in reqs]),
                           device=dev).reshape(1, MAX_BATCH, -1)
    with torch.inference_mode():
        window = swl.engine.route_window(keys, 1)
        plan = LookupPlan(*(x[0] for x in window.plans))
        bkeys = window.buffer_keys
        master_idx = torch.where(bkeys != SENTINEL, bkeys, swl.spec.padded_rows)
        buf_rows = check_gather("retrieve", table.rows, master_idx)
        buf_idx = sorted_lookup(bkeys, plan.recv_keys.reshape(-1))
        served = check_gather("serve-from-buffer", buf_rows, buf_idx)
        unique_emb = check_gather("assemble-1", served, plan.slot_of_unique)
        check_gather("assemble-2", unique_emb, plan.inverse)
    serve_shapes = []
    for label, src, idx in (("retrieve", table.rows, master_idx),
                            ("serve-from-buffer", buf_rows, buf_idx),
                            ("assemble-1", served, plan.slot_of_unique),
                            ("assemble-2", unique_emb, plan.inverse)):
        lib_idx = idx.clamp(0, src.shape[0] - 1).long()
        nbytes = gather_bytes(torch, src, idx)
        serve_shapes.append({
            "kernel": "embedding_gather", "call": label, "src_rows": src.shape[0],
            "n": idx.numel(), "dim": src.shape[1], "bytes": nbytes,
            "ms": time_ms(torch, lambda: eg.embedding_gather(src, idx), flush),
            "plain_ms": time_ms(torch, lambda: ref.gather_rows_ref(src, idx), flush),
            "library_ms": time_ms(
                torch, lambda: torch.index_select(src, 0, lib_idx), flush),
            "bound_ms": nbytes / peak * 1e3,
        })
        emit("kernel_shape", path="serve", **serve_shapes[-1])
    del flush

    # one unchecked warm-up pass, then the counted one
    sess.serve_embeddings(num_requests=2 * MAX_BATCH, max_batch=MAX_BATCH,
                          head="dlrm")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    srep = sess.serve_embeddings(num_requests=N_REQUESTS, max_batch=MAX_BATCH,
                                 head="dlrm", check_exact=True)
    wall = time.perf_counter() - t0
    serve_launches = counts()
    s = srep.summary
    windows = int(s["windows"])
    chunks = -(-N_REQUESTS // MAX_BATCH)
    emit("serve", arch=ARCH, head="dlrm", weights="trained", requests=N_REQUESTS,
         max_batch=MAX_BATCH, windows=windows, qps=s["qps"],
         latency_p50_ms=s["latency_p50_ms"], latency_p99_ms=s["latency_p99_ms"],
         serve_wall_s=s["wall_s"], total_wall_s=wall,
         exact=s["exact"], max_abs_diff=s["max_abs_diff"],
         launches=serve_launches, ground_truth_chunks=chunks,
         table_device=str(table.rows.device), table_rows=table.rows.shape[0],
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if s["exact"] != 1:
        raise SystemExit(f"served logits differ from the master ground truth: {s}")
    if table is not sess.state.table:
        raise SystemExit("serving did not read the trained master")
    if serve_launches["embedding_gather"] != 4 * windows + 3 * chunks:
        raise SystemExit(f"gather launches {serve_launches} != 4 x {windows} "
                         f"windows + 3 x {chunks} ground-truth chunks")
    if srep.results.shape != (N_REQUESTS,) or not np.isfinite(srep.results).all():
        raise SystemExit("served logits are not finite of shape (requests,)")

    if args.profile:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.serve_embeddings(num_requests=N_REQUESTS, max_batch=MAX_BATCH,
                                  head="dlrm")
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "serve_profile", span, requests=N_REQUESTS)
    del sess, model, table, master, state, rep, srep

    # -- 7. consistency at the reduced size ---------------------------------
    kw = dict(reduced=True, global_batch=32, n_micro=N_MICRO, seed=1)
    base = Session.from_arch(ARCH, **kw)
    init = clone_state(base.state)
    finals = {}
    for mode in ("nestpipe", "serial", "async"):
        run = Session.from_arch(ARCH, mode=mode, **kw)
        run.state = clone_state(init)
        finals[mode] = run.train(CONSISTENCY_STEPS)
    rwl = base.workload
    ref_step = build_reference_step(make_dlrm_loss_fn(rwl.cfg), base.optimizer,
                                    constant_lr(base.opt_cfg.lr, dev), N_MICRO)
    transform = make_cluster_transform(N_MICRO, rwl.npcfg.clustering)
    stream = resolve_stream(rwl, base.seed)
    ref_state = clone_state(init)
    with torch.no_grad():
        for _ in range(CONSISTENCY_STEPS):
            b = transform(next(stream))
            b.pop("raw_keys")
            ref_state, _ = ref_step(ref_state, stage_to_device(b, dev))

    def gap(a, b):
        parts = [a.table.rows - b.table.rows, a.table.accum - b.table.accum]
        parts += [a.dense[k] - b.dense[k] for k in a.dense]
        return max(float(x.abs().max()) for x in parts)

    gaps = {mode: gap(r.state, ref_state) for mode, r in finals.items()}
    gaps["nestpipe_vs_serial"] = gap(finals["nestpipe"].state, finals["serial"].state)
    emit("consistency", arch=ARCH + " (reduced)", steps=CONSISTENCY_STEPS,
         max_abs_diff_to_reference=gaps,
         losses={m: r.stats.losses for m, r in finals.items()})
    if max(gaps["nestpipe"], gaps["serial"], gaps["nestpipe_vs_serial"]) > 1e-5:
        raise SystemExit(f"nestpipe/serial differ from the reference: {gaps}")
    if gaps["async"] <= 1e-6:
        raise SystemExit(f"async did not diverge from the reference: {gaps}")

    # -- 8. kernels line and the result ------------------------------------
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        rows = shapes[kname]
        launched = train_launches[kname] + serve_launches[kname]
        if train_launches[kname] == 0:
            raise SystemExit(f"{kname} was not launched on the training path")
        entry = {
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched,
            "launches_by_path": {"train": train_launches[kname],
                                 "serve": serve_launches[kname]},
            "max_abs_err": worst[kname],
            "ms": sum(x["ms"] for x in rows),
            "plain_ms": sum(x["plain_ms"] for x in rows),
            "bound_ms": sum(x["bound_ms"] for x in rows),
            "bound_by": "bytes",
            "library_ms": (None if any(x["library_ms"] is None for x in rows)
                           else sum(x["library_ms"] for x in rows)),
            "per_train_step_of": [x["call"] for x in rows],
        }
        if kname == "embedding_gather":
            if serve_launches[kname] == 0:
                raise SystemExit("embedding_gather was not launched on the serving path")
            entry["serve_window"] = {k: sum(x[k] for x in serve_shapes)
                                     for k in ("ms", "plain_ms", "library_ms",
                                               "bound_ms")}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def emit_profile(prof, phase, span, **fields):
    """Device busy time and idle share of a profiled span, and its top ops."""
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events)
    host_ops_us = sum(e.self_cpu_time_total for e in events)
    by_device = sorted(events, key=lambda e: -e.self_device_time_total)
    by_host = sorted(events, key=lambda e: -e.self_cpu_time_total)
    emit(phase, **fields, wall_ms=span * 1e3, device_busy_ms=device_us / 1e3,
         device_idle_share=1 - device_us / 1e3 / (span * 1e3),
         host_torch_ops_ms=host_ops_us / 1e3,
         top_device=[{"name": e.key[:70], "count": e.count,
                      "ms": e.self_device_time_total / 1e3} for e in by_device[:12]],
         top_host=[{"name": e.key[:70], "count": e.count,
                    "ms": e.self_cpu_time_total / 1e3} for e in by_host[:10]])


if __name__ == "__main__":
    sys.exit(main())
