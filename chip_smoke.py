#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``src/repro_torch``).

Drives the port's main paths once on one NVIDIA GPU and holds every
hand-written kernel on it against its plain PyTorch version:

1. environment: the card's name and power limit, torch and CUDA versions,
   TF32 switched off for matmuls and convolutions, the host's memory
   (``MemTotal``, ``MemAvailable``) and CPUs; then a pinned host tensor of
   the ``dlrm-ctr`` master's size (29.19 GB): the seconds pinning took, and
   one step's buffer (K = 319,488 rows x 128 f32, 163.6 MB) copied each
   way from it, timed by CUDA events (``pin_probe``);
2. build: compiles every kernel from ``src/repro_torch/csrc`` with nvcc, one
   process per source, all at once; each source's nvcc seconds, ptxas's
   registers and spills (the ``hstu_attention`` forward's by head dim), the
   HGMMA instructions in the wgmma ``flash_attention`` library and the HMMA
   (``mma.sync``) instructions of each ``hstu_attention`` kernel, the
   forward and the two backward kernels apart (``cuobjdump -sass``; none
   fails);
3. kernel edges: ``embedding_gather``, ``segment_rowsum``, ``buffer_sync``
   and ``embedding_scatter`` against their plain versions at edge cases
   (empty, one segment, drop ids and sentinels, negative sources, D in
   {1, 33, 128}, a view off 16-byte alignment; for ``embedding_scatter``
   also every slot a sentinel, one valid slot among 1,000 sentinels, valid
   slots only at lanes 0 and 31 of a 32-slot group, n = 31 and 33, at D in
   {1, 33, 128, 512}; for ``segment_rowsum`` also hot keys, one id's run of
   C - 1, C, C + 1 and 5,400 positions at D 512, C = 64 positions a chunk,
   ``segment_rowsum.CHUNK``; for ``embedding_gather`` also few wide rows,
   n in {1, 8, 32, 33} at D 5,120, rows of 5,121 and views off alignment
   at D 5,120 and 5,121, every slot a sentinel at n 32, D 5,120, and 60,000
   narrow rows with sentinels, f32 and bf16), bit for bit where the sums
   are exact (``segment_rowsum`` against the CPU plain version in its chunk
   order, and the input-order one on integer grads or runs of at most C),
   and the same bits on two runs (every gather check, here and on the
   captured main-path calls, runs the kernel twice);
4. a full-width ``dlrm-ctr`` training session (``mode="nestpipe"``,
   ``global_batch=8192``, N = 4, ``bucket_slack=1.5``) on the 29.19 GB
   table: what ``time_ms`` reads for an empty kernel and for one 16-byte
   row gathered by the kernel and by ``index_select`` (``timing_floor``);
   one warm-up step, then two steps whose kernel calls are captured,
   and every captured call checked against its plain version and timed
   beside the plain version, one PyTorch library call where there is one,
   and its bandwidth bound (``segment_rowsum`` also by part: the sort, the
   starts pass, the sum pass and the combine pass; each gather with the
   launch plan it ran, ``embedding_gather.launch_plan``, bound / ms, and
   its and ``index_select``'s times after a flush that leaves the L2
   clean);
5. main path, training: ``train(8)`` with every launch counted; finite
   losses, no routing overflow, the master still full on the card, rows of
   window 0 changed;
6. main path, serving: the trained weights served from the same session,
   4,096 requests in windows of 512, ``check_exact=True``, gather launches
   counted (and the four gathers of one serving window timed first);
6a. full-width ``dlrm-ctr`` training through the host tier (a pinned
   29.19 GB master in host memory), the cached tier (the default 3.65 GB
   device cache, 8-row chunks, ``freq``), the cached tier again with a
   cache of 131,072 rows under ``lru`` (the default one holds every chunk
   a short run touches, so only this one evicts) and the device tier,
   each from seed 0: one warm-up step, then 10 counted; the same losses and the
   same master rows and adagrad state at every key the steps touched, bit
   for bit; the master pinned, the card holding only the dense model, the
   buffers and the cache while the steps run; per tier step p50 and p99,
   samples/s, host ms per stage, bytes each way and the copies' device
   time (so GB/s), peak device memory, and for the cached tier the hit
   rate after the first step, bursts, admissions and evictions (the
   evicting run must evict); launches counted;
6b. the cached path's kernel calls from those runs (the default cache's
   third assembly: the cache's and the staged misses' rows and their D = 1
   adagrad state; its third admission's pulls and cache scatter; its third
   commit's cache scatter and cold pulls; the evicting run's first
   eviction's pulls), checked bit for bit
   against the plain versions and timed beside ``index_select`` or
   ``index_copy_`` and their byte bounds, each gather with its launch plan;
6c. full-width serving through the cached tier: the master trained in 6a,
   4,096 requests in windows of 512, ``head="dlrm"``, the read horizon on,
   ``check_exact=True`` (``exact`` must be 1); qps, p50 and p99, the hit
   rate and the admissions; launches counted; then the same master served
   again with ``sparse_comm="pack"`` (``exact`` 1, the same results, its
   bytes beside ``off``'s);
6d. each cache policy (freq, lfu, lru, oracle) on ``dlrm-cached``,
   ``dlrm-drift`` and ``dlrm-growth`` (their full sizes) with a 1,024-row
   cache, batch 1,024, 6 steps: the host tier's losses and master bit for
   bit, evictions required; hit rates and evictions printed;
6e. the async stage executor at full width, as in 6a (seed 0, one warm-up
   step, 10 counted): the host tier and the cached tier with
   ``async_stages="on"`` and one stage worker, the host tier with
   ``stage_workers=2`` at lookahead 3, and the host tier at lookahead 3
   under a forced race (window 5's retrieve held until commit 3 is
   submitted); each run's losses and the rows and adagrad state of every
   touched key equal 6a's synchronous run of its tier bit for bit; the
   race's hook log shows it happened, and it ran deferred repairs and more
   than ``steps - 1`` ``buffer_sync`` launches; per run step p50 and p99,
   samples/s, host ms per stage (on the worker threads), bytes and GB/s,
   repairs by kind, the pinned host memory the counted steps allocated
   (the caching host allocator's ``cudaHostAlloc`` calls and bytes), each
   beside the synchronous run's (``--profile``: the device idle share over 4 steps of
   each async tier, beside 6a's);
6f. the sparse-comm modes at full width on 6a's evicting cache (131,072
   rows, lru: the one that commits cold rows), sync and async: ``pack``
   equals 6a's run of that cache (``off``) bit for bit, with
   ``wire_bytes``, ``idx_bytes``, ``h2d_bytes`` and ``d2h_bytes`` beside
   off's; ``int8`` prints its largest loss deviation from off, its
   ``comm_rows_synced`` (required above 0) and ``comm_rows_deferred`` and
   bytes, its losses finite; one more synchronous ``int8`` run syncs every
   cold row (``min_sync_p`` = 1, none deferred, required) and prints its
   deviation, which is the quantization's alone;
7. consistency at the reduced ``dlrm-ctr``: nestpipe = serial = the naive
   reference trainer within 1e-5 over 6 steps, and async diverges; the
   reference, run twice from the same state, gives the same bits (its sum
   has a fixed order); the longest run of one key in a micro-batch, beside
   ``segment_rowsum.CHUNK``, and whether nestpipe equals the reference bit
   for bit;
8. HSTU kernel edges: the ``hstu_attention`` forward and backward kernels
   against their plain versions at T in {1, 33, 256, 1024}, (dqk, dv) in
   {(128, 128), (16, 8), (48, 96)}, and T in {65, 1024} at (5, 3), causal
   and not, on strided q, k, v
   (column slices of one (..., 2dqk + 2dv) tensor, as the layer makes
   them), within 1e-5 of each output's sum of magnitudes plus 1e-7, and the
   same bits on two runs;
9. full-width HSTU training: ``hstu-industrial`` at every published width
   (d_model 1024, 4 layers, 8 heads, T = 1024, dim 512, bf16 lookups) with
   each vocabulary divided by 6.25 to fit one card (a 49.48 GB master,
   ``HSTU_INDUSTRIAL_ONE_CARD``), hand-assembled and run through
   ``Session.from_workload`` with ``mode="nestpipe"``, batch 256, N = 4,
   ``bucket_slack=1.5``: one warm-up step, two steps whose kernel calls
   are captured (the first ``hstu_attention`` forward and backward, and
   the embedding kernels' calls as in phase 4), the embedding kernels'
   calls checked and timed as in phase 4, then ``train(6)`` with every
   launch counted; finite losses, no routing overflow, peak memory,
   samples/s, tokens/s, step p50 and p99 (``--profile``: the device idle
   share over 2 more steps); then, with the session released, the captured
   attention calls checked against the plain versions and timed beside
   their FP32 and 3xTF32 bounds, the forward also in TF32 MMA TFLOP/s and
   its share of the TF32 peak (exactly 32 forward calls a step);
10. consistency at ``hstu-reduced``: nestpipe = serial = the reference
   trainer over 6 steps, and async diverges, at the configuration's own
   step sizes and at the smaller ones of the CPU parity tests; the
   reference gives the same bits twice, and the longest key run is printed
   as in phase 7;
11. release: every earlier session gone (the memory still allocated is
   printed);
12. ``flash_attention`` edges: both kernels against the plain version at
   T in {1, 33, 64, 257, 2048}, hd in {16, 64, 80, 128, 160, 192, 256},
   H/KV in {1, 4}, causal and not, f32 and bf16 (bf16 at the wgmma kernel's
   head dims goes to it, and to the general kernel too at T 33 and 257; the
   rest to the general kernel, each asserted by its counter), Tq 33 against
   Tk 100, and strided views (off 16-byte alignment, and 16-byte aligned),
   within ``ref.flash_attention_bound``
   (f32: 1e-5 of each output's sum of |w v| + 1e-7; bf16: 2**-8 of it plus
   one bf16 ulp); the same bits on two runs; the same values give the same
   bits through ``flash_attention`` in a contiguous layout and in each
   layout a TMA map cannot describe (off 16-byte alignment, a row stride of
   164, heads outside positions), each through the wgmma kernel (its
   counter moves); a CUDA tensor beside a CPU one raises;
13. full-width ``stablelm-12b`` serving (40 layers, d_model 5,120, 32
   heads over 8 kv heads of 160, bf16; 23.26 GB of weights and a 2.06 GB
   master drawn from a seed): ``serve(batch=8, prompt_len=2048, gen=32)``
   once as warm-up, with the first and the last layer's ``flash_attention``
   calls captured and the gathers of the prefill's lookup and of the first
   decode step's (the f32 master retrieve at D = 5,120, two bf16 assembly
   gathers) checked bit for bit and timed as in phase 6, then once counted
   (40 launches of the wgmma flash kernel, all in the prefill, none of the
   general one; 3 gathers per lookup, 32 lookups) with the same tokens; the
   captured flash calls checked at full shape against the plain version,
   through both kernels, and timed beside the general kernel, the plain
   version, SDPA and their bound; a second prefill whose attention
   runs the plain version agrees on the last-token logits within 5e-2 of
   max |logit| (``--profile``: the device idle share of a prefill and of 8
   decode steps);
14. a ``{"kernels": [...]}`` line (the gather's LM serve as its 96 calls,
   and apart as the prefill's three and one decode step's three; the
   gather's and the scatter's cached-path calls of 6b as
   ``dlrm_cached_train_calls``; launches by path, the host and cached
   tiers' training, every run of 6e and 6f, and the cached tier's serving
   with and without ``pack`` among them) and, last,
   the ``{"ok": true, ...}`` line.

Every phase prints one JSON line. Nothing is caught: any failure exits
non-zero. Run from the repo root: ``python3 chip_smoke.py`` (``--profile``
adds a host breakdown and a ``torch.profiler`` pass over 4 training steps
and over the serving path, one over 4 more steps of the host and of the
cached tier (read between a run's first stage after its ingest and its
release), one over 2 HSTU steps, and one over an LM prefill and 8 decode
steps).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import weakref
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
# the host and cached tiers at full width: counted steps after one warm-up.
# The default cache (padded_rows / 8, 890,813 chunks) holds every chunk a
# short run touches (~38k new a window), so a second cached run, with a
# cache of 16,384 chunks under lru, evicts.
TIER_STEPS = 10
# phase 6e: the async stage executor at full width, each run held to 6a's
# synchronous run of its tier; the forced race holds window RACE_WINDOW's
# retrieve until commit RACE_COMMIT is submitted
ASYNC_RUNS = (("host-async", "host", {"async_stages": "on"}),
              ("cached-async", "cached", {"async_stages": "on"}),
              ("host-async-w2-k3", "host",
               {"async_stages": "on", "stage_workers": 2, "prefetch_ahead": 3}),
              ("host-async-race-k3", "host", {"async_stages": "on", "prefetch_ahead": 3}))
RACE_WINDOW, RACE_COMMIT = 5, 3
# phase 6f: the sparse-comm modes on 6a's evicting cache, sync and async,
# held to 6a's run of that cache (off): pack bit for bit, int8 by its loss
# deviation. The default cache holds every row 11 windows touch, so only
# the evicting one commits cold rows: int8's selective sync runs there.
COMM_CACHE = {"cache_rows": 131_072, "cache_policy": "lru"}
COMM_RUNS = tuple((f"cached-evicting-{mode}" + ("-async" if on else ""), "cached",
                   {**COMM_CACHE, "sparse_comm": mode,
                    **({"async_stages": "on"} if on else {})})
                  for mode in ("pack", "int8") for on in (False, True)) + (
    # int8 with every cold row synced at each commit (min_sync_p = 1): the
    # quantization's share of int8's loss deviation, without deferral's
    ("cached-evicting-int8-sync-all", "cached", {**COMM_CACHE, "sparse_comm": "int8"}),)
INT8_SYNC_ALL = "cached-evicting-int8-sync-all"
# The default cached run comes last: its session, and its 29.19 GB master
# on the card, serve in 6c.
TIER_RUNS = (("host", "host", {}),
             ("cached-evicting", "cached", COMM_CACHE),
             ("device", "device", {}), ("cached", "cached", {}))
# every cache policy against the host tier, on the archs whose full size is
# their reduced one, with a cache small enough to evict
POLICY_ARCHS = ("dlrm-cached", "dlrm-drift", "dlrm-growth")
POLICY_BATCH, POLICY_STEPS, POLICY_CACHE_ROWS = 1024, 6, 1024
HSTU_BATCH = 256  # the per-worker share of the 65,536 recsys batch over 256 workers
HSTU_STEPS = 6
# the hstu_attention forward's calls a step: 4 layers x 4 micro-batches x 2
# (each layer's forward runs again in the backward: per-layer remat)
HSTU_FWD_CALLS_PER_STEP = 32
# HSTU's kernels against their plain versions: within HSTU_RTOL of each
# output's sum of magnitudes (ref.hstu_attention_magnitudes) plus HSTU_ATOL;
# the two add the same terms in different orders.
HSTU_RTOL, HSTU_ATOL = 1e-5, 1e-7
# hstu-reduced consistency runs twice: at the configuration's own step sizes
# and at the rowwise-Adagrad step and AdamW eps of the CPU parity tests,
# where rounding does not grow (tests/test_torch_train.py says why). Both
# hold rows and dense params within 1e-5 and the adagrad accumulator within
# 1e-4 of 1 + accum.
HSTU_SMALL_STEPS = {"sparse_lr": 0.002, "adam_eps": 1e-6}
LM_ARCH = "stablelm-12b"
# one card's share of decode_32k (batch 128 over 32,768 positions, an
# 859 GB cache at 204,800 B a token): batch 8, 2,048-token prompts, 32 new
LM_BATCH, LM_PROMPT, LM_GEN = 8, 2048, 32
# the prefill's last-token logits with the kernel and with the plain
# attention: within this share of max |logit| (bf16 activations through 40
# layers; a wrong kernel differs by O(1))
LM_LOGIT_RTOL = 5e-2
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
    # the TPU kernel is forward only; JAX differentiates the layer's jnp form
    "hstu_attention_fwd": ("src/repro_torch/csrc/hstu_attention.cu",
                           "src/repro/kernels/hstu_attention.py:56"),
    "hstu_attention_bwd": ("src/repro_torch/csrc/hstu_attention.cu",
                           "src/repro/kernels/hstu_attention.py:56"),
    # two kernels of one function: the main path's and the general one
    "flash_attention_wgmma": ("src/repro_torch/csrc/flash_attention_wgmma.cu",
                              "src/repro/kernels/flash_attention.py:70"),
    "flash_attention_simple": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:70"),
}
# the paths each kernel must run on (launched at least once there); 6e's and
# 6f's runs are paths of their own
TIER_PATHS = {run: "dlrm_" + run.replace("-", "_") + "_train"
              for run, _, _ in ASYNC_RUNS + COMM_RUNS}
CACHED_PATHS = tuple(TIER_PATHS[run] for run, store, _ in ASYNC_RUNS + COMM_RUNS
                     if store == "cached") + ("dlrm_cached_pack_serve",)
RUNS_ON = {
    "embedding_gather": ("dlrm_train", "dlrm_serve", "dlrm_host_train",
                         "dlrm_cached_train", "dlrm_cached_serve", "hstu_train",
                         "lm_serve", "dlrm_cached_pack_serve") + tuple(TIER_PATHS.values()),
    "segment_rowsum": ("dlrm_train", "dlrm_host_train", "dlrm_cached_train",
                       "hstu_train") + tuple(TIER_PATHS.values()),
    "buffer_sync": ("dlrm_train", "dlrm_host_train", "dlrm_cached_train", "hstu_train")
    + tuple(TIER_PATHS.values()),
    # the host tier writes its master back on the host: no device scatter
    "embedding_scatter": ("dlrm_train", "dlrm_cached_train", "dlrm_cached_serve",
                          "hstu_train") + CACHED_PATHS,
    "hstu_attention_fwd": ("hstu_train",),
    "hstu_attention_bwd": ("hstu_train",),
    "flash_attention_wgmma": ("lm_serve",),
    # f32 and other head dims (phase 12); no main path gives it such inputs
    "flash_attention_simple": (),
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


def peak_flops_fp32(torch, name: str) -> float:
    """The f32 CUDA-core peak: SMs x 128 lanes x 2 operations (an FMA) x
    the maximum SM clock nvidia-smi reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * 2 * mhz * 1e6


def tf32_flops(name: str) -> float:
    """Dense TF32 tensor-core peak (NVIDIA data sheets, SXM parts)."""
    if "H100" in name or "H200" in name:
        return 495e12
    raise SystemExit(f"chip_smoke: no TF32 figure for {name!r}")


def bf16_flops(name: str) -> float:
    """Dense bf16 tensor-core peak (NVIDIA data sheets, SXM parts)."""
    if "H100" in name or "H200" in name:
        return 989e12
    raise SystemExit(f"chip_smoke: no bf16 figure for {name!r}")


def flash_work(q, k, causal):
    """(operations, bytes) of ``flash_attention`` for these inputs: 4 hd per
    unmasked (query, key) pair (the score and the weighted sum); q, k, v
    read once and the output written once."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    if causal:  # query i sees keys 0..min(i, Tk - 1)
        pairs_per_head = sum(min(i + 1, tk) for i in range(tq))
    else:
        pairs_per_head = tq * tk
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return 4 * hd * b * h * pairs_per_head, nbytes


def hstu_work(q, dv, causal):
    """(forward, backward) operations of ``hstu_attention`` for these
    inputs: per unmasked (query, key) pair, 2 dqk + 2 dv forward (the score
    and the weighted sum) and 2 (3 dqk + 2 dv) backward (the score again,
    dA, dV, dQ, dK)."""
    b, t, h, dqk = q.shape
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    return pairs * 2 * (dqk + dv), pairs * 2 * (3 * dqk + 2 * dv)


def hstu_fwd_mma_ops(q, dv, causal):
    """TF32 MMA operations the ``hstu_attention`` forward kernel issues for
    these inputs, its three passes included: each warp (16 query rows of a
    128-row block) runs, per step of 32 keys up to T (causal: up to the
    block's last row, skipping steps wholly after the warp's rows), two
    products of 16 x 32 x kD, kD the head dim padded to 16, 32, 64 or 128."""
    b, t, h, dqk = q.shape
    kd = next(p for p in (16, 32, 64, 128) if p >= max(dqk, dv))
    warp_steps = 0
    for row0 in range(0, t, 16):
        block_steps = -(-(min(t, row0 // 128 * 128 + 128) if causal else t) // 32)
        warp_steps += min(block_steps, (row0 + 15) // 32 + 1) if causal else block_steps
    return b * h * warp_steps * 2 * (2 * 16 * 32 * kd) * 3


def sass_counts(path, op: str) -> dict:
    """Per kernel of a built library, the SASS instructions whose line holds
    ``op`` (``cuobjdump -sass``); None where cuobjdump fails."""
    out = subprocess.run(["cuobjdump", "-sass", str(path)], capture_output=True, text=True)
    if out.returncode != 0:
        return None
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and op in line:
            counts[fn] += 1
    return counts


def ptxas_by_kernel(report: str) -> dict:
    """Per kernel of a ptxas -v report: registers and spilled bytes."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def longest_key_run(batches) -> int:
    """The most positions one key takes in one micro-batch of ``batches``
    (each ``keys`` stacked (N, ...))."""
    import torch

    return max(int(torch.unique(b["keys"][i].reshape(-1), return_counts=True)[1].max())
               for b in batches for i in range(b["keys"].shape[0]))


def same_bits(a, b) -> bool:
    """Two train states with the same bits in table, accumulator and dense
    params."""
    import torch

    return (torch.equal(a.table.rows, b.table.rows) and torch.equal(a.table.accum, b.table.accum)
            and all(torch.equal(a.dense[k], b.dense[k]) for k in a.dense))


def time_ms(torch, fn, flush, clean=False) -> float:
    """Median device time of ``fn`` over TIMED_RUNS launches, each timed
    alone with CUDA events after a write of ``flush`` evicts the 50 MB L2
    (the main path finds the master table cold). The write leaves the L2
    full of dirty lines, so ``fn``'s first ~50 MB of traffic also writes
    them back, as it would after a kernel that wrote as much; ``clean``
    evicts them by a read of ``flush`` instead. A ~100 us spin after the
    flush keeps the card busy until ``fn`` is queued, so the events time
    the device work and not the host's launch overhead."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(TIMED_RUNS):
        if clean:
            flush.sum()
        else:
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
    from repro_torch.configs import ArchSpec, NestPipeConfig, OptimizerConfig, get_arch
    from repro_torch.configs.recsys_archs import HSTU_INDUSTRIAL_ONE_CARD, HSTU_ROW_CUT
    from repro_torch.core.consistency import build_reference_step
    from repro_torch.core.embedding.engine import LookupPlan
    from repro_torch.core.embedding.routing import SENTINEL, sorted_lookup
    from repro_torch.core.store import CACHE_POLICIES, CachedStore, HostStore, SparseComm
    from repro_torch.data.pipeline import make_cluster_transform, stage_to_device
    from repro_torch.kernels import build, dispatch, ref
    from repro_torch.kernels import buffer_sync as bs
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import embedding_scatter as es
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hstu_attention as ha
    from repro_torch.kernels import segment_rowsum as sr
    from repro_torch.launch.build import assemble_workload, make_loss_fn, resolve
    from repro_torch.models.dlrm import make_dlrm_loss_fn
    from repro_torch.serve import synthetic_requests
    from repro_torch.train import clone_state, constant_lr

    dev = torch.device("cuda")
    mods = {"embedding_gather": eg, "segment_rowsum": sr, "buffer_sync": bs,
            "embedding_scatter": es}

    def reset_counts():
        for m in mods.values():
            m.launches = 0
        ha.launches_fwd = ha.launches_bwd = 0
        fa.launches = fa.launches_wgmma = fa.launches_simple = 0

    def counts():
        return {**{k: m.launches for k, m in mods.items()},
                "hstu_attention_fwd": ha.launches_fwd,
                "hstu_attention_bwd": ha.launches_bwd,
                "flash_attention_wgmma": fa.launches_wgmma,
                "flash_attention_simple": fa.launches_simple}

    # -- 1. environment ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peak = peak_bytes_per_s(name)
    meminfo = {ln.split(":")[0]: int(ln.split()[1]) * 1024
               for ln in Path("/proc/meminfo").read_text().splitlines()
               if ln.split(":")[0] in ("MemTotal", "MemAvailable")}
    emit("env", nvidia_smi=smi[0], device=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         peak_bytes_per_s=peak, host_mem_total_gb=meminfo["MemTotal"] / 1e9,
         host_mem_available_gb=meminfo["MemAvailable"] / 1e9,
         cpu_count=os.cpu_count(), cpus_usable=len(os.sched_getaffinity(0)))

    # the host tier's master, pinned: how long pinning a tensor of its size
    # takes, and one step's buffer (K rows x 128 f32) copied each way
    tier_wl = resolve(ARCH, device=dev, npcfg=NestPipeConfig(
        fwp_microbatches=N_MICRO, bucket_slack=SLACK), global_batch=TRAIN_BATCH)
    tier_k = tier_wl.engine.dims(tier_wl.batch_shapes["keys"][0][1:], N_MICRO).buffer_cap
    t0 = time.perf_counter()
    probe = torch.empty((tier_wl.spec.padded_rows, tier_wl.spec.dim), pin_memory=True)
    pin_s = time.perf_counter() - t0
    on_card = torch.empty((tier_k, tier_wl.spec.dim), device=dev)
    copy_ms = {}
    for way, (dst, src) in (("h2d", (on_card, probe[:tier_k])),
                            ("d2h", (probe[:tier_k], on_card))):
        times = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        copy_ms[way] = statistics.median(times)
    del dst, src  # the probe's views: its pinned block goes back to the cache
    buf_bytes = on_card.numel() * 4
    emit("pin_probe", master_gb=probe.numel() * 4 / 1e9, pin_s=pin_s,
         pinned=probe.is_pinned(),
         host_pinned_allocated_gb=torch.cuda.host_memory_stats().get(
             "allocated_bytes.current", 0) / 1e9,
         buffer_rows=tier_k, buffer_mb=buf_bytes / 1e6,
         h2d_ms=copy_ms["h2d"], d2h_ms=copy_ms["d2h"],
         h2d_gb_per_s=buf_bytes / copy_ms["h2d"] / 1e6,
         d2h_gb_per_s=buf_bytes / copy_ms["d2h"] / 1e6)
    if not probe.is_pinned():
        raise SystemExit("the pinned probe tensor is not pinned")
    tier_dim = tier_wl.spec.dim
    del probe, on_card, tier_wl

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    sass = subprocess.run(["cuobjdump", "-sass", str(build.library_path("flash_attention_wgmma"))],
                          capture_output=True, text=True)
    hgmma = sass.stdout.count("HGMMA") if sass.returncode == 0 else None
    if hgmma == 0:
        raise SystemExit("the wgmma flash_attention library holds no HGMMA instruction")
    # every hstu_attention product: mma.sync m16n8k8 TF32 (HMMA.1688), per
    # kernel (summed over its head-dim instantiations)
    per_fn = sass_counts(build.library_path("hstu_attention"), "HMMA")
    hmma = None if per_fn is None else {
        kn: sum(c for fn, c in per_fn.items() if kn in fn)
        for kn in ("hstu_fwd_kernel", "hstu_bwd_dq_kernel", "hstu_bwd_dkdv_kernel")}
    if hmma is not None and min(hmma.values()) == 0:
        raise SystemExit(f"an hstu_attention kernel holds no HMMA instruction: {hmma}")
    if per_fn is not None and len([fn for fn in per_fn if "hstu_fwd_kernel" in fn]) != 4:
        raise SystemExit(f"the hstu_attention library's kernels: {sorted(per_fn)}")
    # the forward's registers and spills by padded head dim (kernel<kD>)
    fwd_ptxas = {"d" + re.search(r"ILi(\d+)E", fn).group(1): v for fn, v in ptxas_by_kernel(
        build.build_log.get("hstu_attention", {}).get("ptxas", "")).items()
        if "hstu_fwd_kernel" in fn}
    emit("build", seconds=round(build_s, 3), sources=list(build.SOURCES),
         nvcc_seconds={k: round(v["seconds"], 3) for k, v in build.build_log.items()},
         flash_wgmma_hgmma_instructions=hgmma, hstu_hmma_instructions=hmma,
         hstu_fwd_ptxas=fwd_ptxas,
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
        if not torch.equal(got, eg.embedding_gather(src, idx)):
            raise SystemExit(f"embedding_gather not deterministic at {label}")
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
        if ids.numel() <= 65536:  # on the CPU, bit for bit, in the kernel's chunk order
            cg, ci = grads.cpu(), ids.cpu()
            record("segment_rowsum", [got.cpu()], [ref.segment_rowsum_chunked_ref(
                cg, ci, segments, chunk=sr.CHUNK)], label)
            kept = ci[(ci >= 0) & (ci < segments)].long()
            if integer or kept.numel() == 0 or int(torch.bincount(kept).max()) <= sr.CHUNK:
                # exact sums, or every run one chunk: the input order's bits too
                record("segment_rowsum", [got.cpu()],
                       [ref.segment_rowsum_ref(cg, ci, segments)], label)
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
        again, again_acc = table.clone(), table_accum.clone()
        want, want_acc = table.clone(), table_accum.clone()
        es.embedding_scatter(got, got_acc, idx, rows, accum)
        es.embedding_scatter(again, again_acc, idx, rows, accum)
        if not (torch.equal(got, again) and torch.equal(got_acc, again_acc)):
            raise SystemExit(f"embedding_scatter not deterministic at {label}")
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
        # bf16 rows: the lookups of a model that computes in bf16 (HSTU)
        check_gather(f"bf16 D={d}", t.to(torch.bfloat16), randint(-2, 1002, 777))
        check_gather(f"bf16 misaligned D={d}", misaligned(t.to(torch.bfloat16)),
                     randint(-2, 1002, 513))
        edge.append(f"gather bf16 D={d},aligned and misaligned")
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
    # the write-back's sentinel-heavy slots: the kernel takes 32 slots a warp
    # and keeps the valid ones by a ballot
    for d in (1, 33, 128, 512):
        r = 1000
        table = torch.empty((r, d), device=dev).normal_(generator=g)
        one = torch.full((1001,), SENTINEL, dtype=torch.int32, device=dev)
        one[517] = 7
        lanes = torch.full((96,), SENTINEL, dtype=torch.int32, device=dev)
        lanes[0::32] = torch.tensor([3, 500, 999], dtype=torch.int32, device=dev)
        lanes[31::32] = torch.tensor([0, 42, 998], dtype=torch.int32, device=dev)
        cases = [("every slot a sentinel", torch.full((300,), SENTINEL, dtype=torch.int32,
                                                      device=dev)),
                 ("one valid among 1,000 sentinels", one),
                 ("valid only at lanes 0 and 31", lanes)]
        for n in (31, 33):
            idx = torch.randperm(r, device=dev, generator=g)[:n].to(torch.int32)
            idx[::4] = SENTINEL
            idx[1::9] = -1
            cases.append((f"n={n}", idx))
        for label, idx in cases:
            n = idx.numel()
            rows = torch.empty((n, d), device=dev).normal_(generator=g)
            check_scatter(f"{label} D={d}", table, torch.rand(r, device=dev), idx, rows,
                          torch.rand(n, device=dev))
            check_scatter(f"misaligned {label} D={d}", misaligned(table),
                          torch.rand(r, device=dev), idx, misaligned(rows),
                          torch.rand(n, device=dev))
            edge.append(f"embedding_scatter {label}, D={d}")
    # hot keys: one id's run of C - 1, C, C + 1 and 5,400 positions (HSTU's
    # hot row in a micro-batch) among singles and drops, at D = 512
    for run in (sr.CHUNK - 1, sr.CHUNK, sr.CHUNK + 1, 5400):
        ids = randint(0, 4096, run + 4096)
        ids[torch.randperm(ids.numel(), device=dev, generator=g)[:run]] = 3
        ids[::37] = SENTINEL
        for integer in (True, False):
            grads = torch.empty((ids.numel(), 512), device=dev).normal_(generator=g)
            if integer:
                grads = torch.round(grads * 8)
            check_segment(f"hot run {run} D=512", grads, ids, 4096, integer)
            check_segment(f"misaligned hot run {run} D=512", misaligned(grads), ids, 4096,
                          integer)
        edge.append(f"segment_rowsum hot run of {run} at D=512, L={ids.numel()}, S=4096")
    # the gather's few wide rows (a row split over warps and blocks, as the
    # LM decode's 32 x 5,120 f32 and 8 x 5,120 bf16 calls), rows of 5,121
    # (no 16-byte vectors), every slot a sentinel, and many narrow rows
    wide = torch.empty((1000, 5120), device=dev).normal_(generator=g)
    odd = torch.empty((1000, 5121), device=dev).normal_(generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        w, o = wide.to(dtype), odd.to(dtype)
        kind = str(dtype).removeprefix("torch.")
        for n in (1, 8, 32, 33):
            idx = randint(0, 1000, n)
            idx[1::5] = SENTINEL
            check_gather(f"{kind} D=5120 n={n}", w, idx)
            edge.append(f"gather {kind} D=5120,n={n}")
        for n in (1, 32, 777):
            idx = randint(-2, 1002, n)
            check_gather(f"{kind} D=5121 n={n}", o, idx)
            check_gather(f"{kind} misaligned D=5121 n={n}", misaligned(o), idx)
            check_gather(f"{kind} misaligned D=5120 n={n}", misaligned(w), idx)
            edge.append(f"gather {kind} D=5121 and misaligned D=5120/5121,n={n}")
        check_gather(f"{kind} every slot a sentinel", w,
                     torch.full((32,), SENTINEL, dtype=torch.int32, device=dev))
        edge.append(f"gather {kind} D=5120,n=32,every slot a sentinel")
        narrow = wide[:, :128].contiguous().to(dtype)
        idx = randint(-2, 1002, 60_000)
        idx[::13] = SENTINEL
        check_gather(f"{kind} D=128 n=60000", narrow, idx)
        edge.append(f"gather {kind} D=128,n=60000 with sentinels")
    del wide, odd, w, o, narrow
    torch.cuda.synchronize()
    emit("kernel_edges", cases=edge, max_abs_err=worst,
         exact="bit-exact (gathers in f32 and bf16, each the same bits twice), "
               "except segment_rowsum on "
               "normal grads against the card's atomic index_add_: within 1e-6 "
               "of each output's sum of magnitudes + 1e-6 (bit-exact against "
               "the CPU plain version in the kernel's chunk order, and against "
               "the input-order one on integer grads or runs of at most "
               f"{sr.CHUNK})")

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

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    # what time_ms reads for almost no work: an empty kernel, and one
    # 16-byte row gathered by the kernel and by index_select
    tiny, one = torch.zeros((64, 4), device=dev), torch.ones(1, dtype=torch.int32, device=dev)
    one_long = one.long()
    emit("timing_floor", empty_kernel_ms=time_ms(torch, lambda: torch.cuda._sleep(1), flush),
         gather_one_row_ms=time_ms(torch, lambda: eg.embedding_gather(tiny, one), flush),
         index_select_one_row_ms=time_ms(
             torch, lambda: torch.index_select(tiny, 0, one_long), flush))
    del tiny, one, one_long

    def capture_calls(sess):
        """Two training steps with the inputs of the first calls of each
        kind kept: the gathers retrieve 0, retrieve 1 (queued ahead of
        window 0) and window 0's three per micro-batch; the segment sums of
        window 0's micro-batches and its window-to-buffer sum; one
        buffer_sync and one write-back. The master is kept by reference,
        every other tensor copied once (the micro-batches of a window read
        one buffer)."""
        captured = {"gather": [], "segment": [], "sync": [], "scatter": []}
        limits = {"gather": 14, "segment": 5, "sync": 1, "scatter": 1}
        real = {k: getattr(dispatch, k) for k in
                ("gather_rows", "segment_rowsum", "buffer_sync", "scatter_rows")}
        master = sess.state.table
        copies = {}  # id(tensor) -> (weak reference to it, its copy)

        def keep(t):
            if t.data_ptr() in (master.rows.data_ptr(), master.accum.data_ptr()):
                return t
            hit = copies.get(id(t))
            if hit is None or hit[0]() is not t:
                hit = copies[id(t)] = (weakref.ref(t), t.clone())
            return hit[1]

        def capture(kind, fn):
            def run(*a):
                if len(captured[kind]) < limits[kind]:
                    captured[kind].append(tuple(keep(x) if torch.is_tensor(x) else x
                                                for x in a))
                return fn(*a)
            return run

        dispatch.gather_rows = capture("gather", real["gather_rows"])
        dispatch.segment_rowsum = capture("segment", real["segment_rowsum"])
        dispatch.buffer_sync = capture("sync", real["buffer_sync"])
        dispatch.scatter_rows = capture("scatter", real["scatter_rows"])
        try:
            sess.train(2)
        finally:
            for k, fn in real.items():
                setattr(dispatch, k, fn)
        torch.cuda.synchronize()
        if [len(v) for v in captured.values()] != list(limits.values()):
            raise SystemExit(f"capture saw {[len(v) for v in captured.values()]} calls")
        captured["gather"] = captured["gather"][:1] + captured["gather"][2:]
        return captured

    def timed_gather(path, label, src, idx):
        """One gather timed beside its plain version, index_select and its
        bandwidth bound, with the launch plan it ran; one kernel_shape line."""
        lib_idx = idx.clamp(0, src.shape[0] - 1).long()
        nbytes = gather_bytes(torch, src, idx)
        plan = eg.launch_plan(idx.numel(), src.shape[1], src.element_size(),
                              eg.vector_aligned(src, eg.embedding_gather(src, idx)))
        row = {
            "kernel": "embedding_gather", "call": label, "src_rows": src.shape[0],
            "n": idx.numel(), "dim": src.shape[1],
            "dtype": str(src.dtype).removeprefix("torch."), "bytes": nbytes,
            "plan": {"chunk_bytes": plan.chunk_bytes, "rows_per_warp": plan.rows_per_warp,
                     "blocks": plan.blocks, "warps_per_block": plan.warps_per_block,
                     "vec_bytes": plan.vec_bytes},
            "ms": time_ms(torch, lambda: eg.embedding_gather(src, idx), flush),
            "plain_ms": time_ms(torch, lambda: ref.gather_rows_ref(src, idx), flush),
            "library_ms": time_ms(
                torch, lambda: torch.index_select(src, 0, lib_idx), flush),
            "bound_ms": nbytes / peak * 1e3,
            # the same two after a flush that leaves the L2 clean
            "clean_l2_ms": time_ms(torch, lambda: eg.embedding_gather(src, idx), flush,
                                   clean=True),
            "clean_l2_library_ms": time_ms(
                torch, lambda: torch.index_select(src, 0, lib_idx), flush, clean=True),
        }
        row["bound_over_ms"] = row["bound_ms"] / row["ms"]
        emit("kernel_shape", path=path, **row)
        return row

    def check_and_time(path, captured, master):
        """Every captured call checked against its plain version (as at the
        edges) and timed beside the plain version, one PyTorch library call
        where there is one, and its bandwidth bound; one kernel_shape line
        each. Returns the rows by kernel."""
        shapes = {k: [] for k in mods}

        def timed(kernel, label, nbytes, fn, plain, library, **extra):
            row = {"kernel": kernel, "call": label, **extra, "bytes": nbytes,
                   "ms": time_ms(torch, fn, flush),
                   "plain_ms": time_ms(torch, plain, flush),
                   "library_ms": time_ms(torch, library, flush) if library else None,
                   "bound_ms": nbytes / peak * 1e3}
            shapes[kernel].append(row)
            emit("kernel_shape", path=path, **row)

        gather_labels = ["retrieve"] + [f"mb{i}-{part}" for i in range(N_MICRO)
                                        for part in ("serve", "assemble-1", "assemble-2")]
        for label, (src, idx) in zip(gather_labels, captured["gather"]):
            check_gather(label, src, idx)
            shapes["embedding_gather"].append(timed_gather(path, label, src, idx))

        seg_labels = [f"grads_to_owner-mb{i}" for i in range(N_MICRO)] + ["window-to-buffer"]
        for label, (grads, ids, segments) in zip(seg_labels, captured["segment"]):
            check_segment(label, grads, ids, segments, integer=False)
            integral = torch.randint(-8, 8, grads.shape, device=dev, generator=g,
                                     dtype=torch.float32)
            check_segment(label + "-integer", integral, ids, segments, integer=True)
            del integral
            kept = (ids >= 0) & (ids < segments)
            lib_ids, lib_grads = ids[kept].long(), grads[kept]
            run_counts = torch.bincount(lib_ids, minlength=segments)
            # the op's parts, each timed alone on this call's inputs
            sorted_ids, perm = sr.sort_ids(ids)
            starts = sr.find_starts(sorted_ids, segments)
            out, partial = sr.sum_chunks(grads, sorted_ids, perm, starts, segments)
            parts = {
                "sort": time_ms(torch, lambda: sr.sort_ids(ids), flush),
                "starts": time_ms(torch, lambda: sr.find_starts(sorted_ids, segments), flush),
                "sum": time_ms(torch, lambda: sr.sum_chunks(grads, sorted_ids, perm, starts,
                                                            segments), flush),
                "combine": time_ms(torch, lambda: sr.combine(out, partial, sorted_ids, starts),
                                   flush)}
            # chunks after a run's first: the stripes the combine reads
            extra_chunks = int(((run_counts - 1).clamp(min=0) // sr.CHUNK).sum())
            del sorted_ids, perm, starts, out, partial
            timed("segment_rowsum", label, segment_bytes(grads, ids, segments),
                  lambda: sr.segment_rowsum(grads, ids, segments),
                  lambda: ref.segment_rowsum_ref(grads, ids, segments),
                  lambda: torch.zeros((segments, grads.shape[1]), device=dev)
                  .index_add_(0, lib_ids, lib_grads),
                  L=ids.numel(), S=segments, dim=grads.shape[1],
                  in_range=lib_ids.numel(), longest_run=int(run_counts.max()),
                  extra_chunks=extra_chunks, parts_ms=parts,
                  library_call="index_add_ of the in-range rows only, "
                  "selected beforehand")
            del lib_ids, lib_grads

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
            raise SystemExit(f"the write-back timing changed the {path} master")
        torch.cuda.synchronize()
        return shapes

    shapes = check_and_time("dlrm_train", capture_calls(sess), sess.state.table)
    gc.collect()
    torch.cuda.empty_cache()

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
            "buffer_sync": TRAIN_STEPS - 1, "embedding_scatter": TRAIN_STEPS,
            "hstu_attention_fwd": 0, "hstu_attention_bwd": 0,
            "flash_attention_wgmma": 0, "flash_attention_simple": 0}
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

    serve_shapes = [timed_gather("dlrm_serve", label, src, idx) for label, src, idx in (
        ("retrieve", table.rows, master_idx), ("serve-from-buffer", buf_rows, buf_idx),
        ("assemble-1", served, plan.slot_of_unique), ("assemble-2", unique_emb, plan.inverse))]

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
    del sess, model, table, state, rep, srep
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6a. full-width dlrm-ctr training through the host and cached tiers
    # the same seed and steps through each tier, then the device tier: the
    # same losses and the same master rows and adagrad state, bit for bit,
    # at every key the steps touched
    tier_kw = dict(mode="nestpipe", global_batch=TRAIN_BATCH, n_micro=N_MICRO,
                   bucket_slack=SLACK, seed=0)
    touched = []  # the host tier's buffer keys, window by window
    seen = {}  # what the wrapped store methods saw in the current run
    # --profile: a record_function range from a run's first stage after its
    # ingest to its release, the window its device idle share is read over
    marker = {"on": False, "range": None}
    real_tier = {m: getattr(HostStore, m)
                 for m in ("ingest", "route", "plan_from_window", "release")}

    def tier_ingest(self, table):
        t = time.perf_counter()
        out = real_tier["ingest"](self, table)
        torch.cuda.synchronize()
        seen.update(ingest_s=time.perf_counter() - t, fresh=True)
        return out

    def tier_route(self, keys):
        if seen.pop("fresh", False):
            # the run's first stage after ingest (on the driver thread in
            # every mode): the device master is gone
            torch.cuda.synchronize()
            seen["device_gb_running"] = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            if marker["on"]:
                marker["range"] = torch.profiler.record_function("tier_steady")
                marker["range"].__enter__()
        return real_tier["route"](self, keys)

    def tier_plan(self, window, after=None):
        plan = real_tier["plan_from_window"](self, window, after)
        if run_name == "host":
            touched.append(plan.host_keys.copy())
        return plan

    def tier_release(self):
        torch.cuda.synchronize()
        if marker["range"] is not None:
            marker["range"].__exit__(None, None, None)
            marker["range"] = None
        seen.update(peak_device_gb_running=torch.cuda.max_memory_allocated() / 1e9,
                    master_pinned=self.rows.is_pinned() and self.accum.is_pinned(),
                    master_device=str(self.rows.device),
                    master_gb=self.memory_bytes() / 1e9)
        t = time.perf_counter()
        out = real_tier["release"](self)
        torch.cuda.synchronize()
        seen["release_s"] = time.perf_counter() - t
        return out

    # the cached tier's device work, labelled by the store method it runs in:
    # one call of each kept (the third, when the run has one; an eviction's
    # first), every tensor by reference (only the cache is written later)
    cached_calls = {}  # run -> label -> [(kind, args)]
    run_name = None
    label = []
    nth = {}

    def labelled(fn, name):
        def run(self, *a, **kw):
            nth[name] = nth.get(name, -1) + 1
            if name == "evict" and nth[name] > 0 or name != "evict" and nth[name] > 2:
                label.append(None)
            else:
                label.append(name)
                cached_calls[run_name][name] = []
            try:
                return fn(self, *a, **kw)
            finally:
                label.pop()
        return run

    def captured(kind, fn):
        def run(*a):
            if label and label[-1] is not None:
                cached_calls[run_name][label[-1]].append((kind, a))
            return fn(*a)
        return run

    class HookedStrategy:
        """A session's strategy whose drivers get the executor's hooks."""

        def __init__(self, inner, hooks):
            self.inner, self.hooks, self.name = inner, hooks, inner.name

        def build_driver(self, fns, stream, workload, **kw):
            return self.inner.build_driver(fns, stream, workload,
                                           stage_hooks=self.hooks, **kw)

    def tier_run(run, store, capture=True, hooks=None, **kw):
        nonlocal run_name
        run_name = run
        base_gb = torch.cuda.memory_allocated() / 1e9
        tsess = Session.from_arch(ARCH, store=store, **tier_kw, **kw)
        warm_losses = tsess.train(1).stats.losses  # the report holds the table
        torch.cuda.synchronize()
        warm_seen = dict(seen)
        seen.clear()
        patched = []
        if hooks is not None:
            tsess.strategy = HookedStrategy(tsess.strategy, hooks)
        if store == "cached" and capture:
            nth.clear()
            cached_calls[run] = {}
            patched = [(CachedStore, m, getattr(CachedStore, m)) for m in
                       ("_assemble", "_admit_chunks", "_writeback_chunks", "_commit_body")]
            for (c, m, fn), name in zip(patched, ("assemble", "admit", "evict", "commit")):
                setattr(c, m, labelled(fn, name))
            patched += [(dispatch, m, getattr(dispatch, m)) for m in
                        ("gather_rows", "scatter_rows")]
            dispatch.gather_rows = captured("gather", patched[-2][2])
            dispatch.scatter_rows = captured("scatter", patched[-1][2])
        host0 = torch.cuda.host_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        try:
            trep = tsess.train(TIER_STEPS)
            torch.cuda.synchronize()
        finally:
            for c, m, fn in patched:
                setattr(c, m, fn)
            tsess.strategy = getattr(tsess.strategy, "inner", tsess.strategy)
        wall = time.perf_counter() - t0
        host1 = torch.cuda.host_memory_stats()
        launches = counts()
        s = trep.summary
        m = trep.stats.store_metrics
        row = {"run": run, "store": store, "steps": TIER_STEPS, "warmup_steps": 1,
               "losses": trep.stats.losses, "overflow_max": s["overflow_max"],
               "samples_per_s": TRAIN_BATCH * TIER_STEPS / wall, "wall_s": wall,
               # the steps alone (the device-timeline spans), without the
               # run's ingest and release of the master
               "samples_per_s_in_steps": TRAIN_BATCH * len(trep.stats.step_times)
               / sum(trep.stats.step_times),
               "step_ms": [x * 1e3 for x in trep.stats.step_times],
               "step_p50_ms": s["p50_step_s"] * 1e3, "step_p99_ms": s["p99_step_s"] * 1e3,
               "stage_host_ms_per_step": {k: s[k] / TIER_STEPS for k in
                                          ("plan_ms", "retrieve_ms", "commit_ms", "h2d_ms")},
               "launches": launches, "device_gb_before_session": base_gb, **seen,
               "warmup_ingest_s": warm_seen.get("ingest_s"),
               "warmup_release_s": warm_seen.get("release_s")}
        if store != "device":
            row.update({k: m.get(k) for k in (
                "h2d_bytes", "d2h_bytes", "h2d_copy_ms", "d2h_copy_ms", "wire_bytes",
                "idx_bytes", "h2d_bursts", "d2h_bursts", "cache_evictions",
                "cache_hits", "cache_misses", "cache_admissions", "cache_rows_used",
                "cache_capacity")})
            row.update({f"{w}_gb_per_s": m[f"{w}_bytes"] / m[f"{w}_copy_ms"] / 1e6
                        if m[f"{w}_copy_ms"] else None for w in ("h2d", "d2h")})
            row.update({k: s.get(k) for k in ("cache_hit_rate", "cache_hit_rate_steady")})
        row.update(cache_rows=kw.get("cache_rows"), cache_policy=kw.get("cache_policy"),
                   async_stages=s["async_stages"], sparse_comm=s["sparse_comm"],
                   stage_workers=kw.get("stage_workers", 1),
                   prefetch_ahead=kw.get("prefetch_ahead", 1),
                   buffer_sync_launches=launches["buffer_sync"],
                   **{k: s[k] for k in ("async_repairs_at_commit", "async_repairs_deferred",
                                        "async_repairs_ring", "comm_rows_synced",
                                        "comm_rows_deferred") if k in s})
        # pinned host memory the counted steps allocated: the caching host
        # allocator's new blocks (cudaHostAlloc)
        row["host_alloc_in_counted_steps"] = {
            k: host1[k] - host0.get(k, 0) for k in (
                "num_host_alloc", "num_host_free", "host_alloc_time.total",
                "allocated_bytes.allocated", "reserved_bytes.current")
            if k in host1}
        row["host_pinned_allocated_gb"] = torch.cuda.host_memory_stats().get(
            "allocated_bytes.current", 0) / 1e9
        emit("tier_train", arch=ARCH, global_batch=TRAIN_BATCH, n_micro=N_MICRO,
             bucket_slack=SLACK, **row)
        if not all(np.isfinite(trep.stats.losses)) or s["overflow_max"] != 0:
            raise SystemExit(f"the {store} tier's losses or routing are off: {s}")
        return tsess, warm_losses + trep.stats.losses, row

    tier_patches = (("ingest", tier_ingest), ("route", tier_route),
                    ("plan_from_window", tier_plan), ("release", tier_release))
    for m, fn in tier_patches:
        setattr(HostStore, m, fn)
    try:
        tiers = {}
        for run, store, kw in TIER_RUNS:
            tsess, losses, row = tier_run(run, store, **kw)
            if run == "host":
                keys_t = np.unique(np.concatenate(touched))
                keys_t = torch.from_numpy(keys_t[keys_t != SENTINEL].astype(np.int64)).to(dev)
            table = tsess.state.table
            tiers[run] = (losses, table.rows[keys_t], table.accum[keys_t], row)
            del table  # the next run of this session frees it
            gc.collect()
            torch.cuda.empty_cache()
            if args.profile and run in ("host", "cached"):
                # 4 more steps, after the comparison's rows were taken
                marker["on"] = True
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    tsess.train(4)
                    torch.cuda.synchronize()
                    span = time.perf_counter() - t0
                marker["on"] = False
                emit_profile(prof, "tier_profile", span, window="tier_steady",
                             run=run, steps=4)
                del prof
            if run == "cached":
                csess = tsess  # serves in 6c
            del tsess
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for m, fn in real_tier.items():
            setattr(HostStore, m, fn)
    # what 6e and 6f hold their runs to: each tier's synchronous run
    sync_ref = {run: tiers[run] for run in ("host", "cached", "cached-evicting")}
    dev_losses, dev_rows, dev_accum, _ = tiers["device"]
    same = {run: {"losses": tiers[run][0] == dev_losses,
                  "rows": torch.equal(tiers[run][1], dev_rows),
                  "accum": torch.equal(tiers[run][2], dev_accum)}
            for run in tiers if run != "device"}
    emit("tier_consistency", arch=ARCH, steps=1 + TIER_STEPS,
         touched_keys=keys_t.numel(), equal_to_device_tier=same,
         device_losses=dev_losses)
    for run in same:
        row = tiers[run][3]
        if not all(same[run].values()):
            raise SystemExit(f"the {run} run differs from the device tier: {same}")
        if not row["master_pinned"] or row["master_device"] != "cpu":
            raise SystemExit(f"the {run} run's master is not pinned host memory")
        # on the card: the dense model, the buffers and (cached) the cache
        cache_gb = (row["cache_capacity"] or 0) * (tier_dim * 4 + 4) / 1e9
        if row["device_gb_running"] - row["device_gb_before_session"] > cache_gb + 1.0:
            raise SystemExit(f"the {run} run holds more than its cache on the card: {row}")
    if tiers["cached-evicting"][3]["cache_evictions"] == 0:
        raise SystemExit("the full-width cached run with a small cache evicted nothing")
    host_train_launches = tiers["host"][3]["launches"]
    cached_train_launches = tiers["cached"][3]["launches"]
    del tiers, dev_rows, dev_accum
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6b. the cached path's kernel calls, checked and timed ---------------
    need = {"assemble": ("gather",) * 4, "admit": ("gather", "gather", "scatter"),
            "evict": ("gather", "gather"), "commit": ("scatter",)}
    calls_of = {lab: cached_calls["cached-evicting" if lab == "evict" else "cached"]
                .get(lab, []) for lab in need}
    for lab, kinds in need.items():
        got = tuple(k for k, _ in calls_of[lab])
        if got[:len(kinds)] != kinds:
            raise SystemExit(f"the cached tier's {lab} ran {got}, not {kinds}")
    cached_shapes = {"embedding_gather": [], "embedding_scatter": []}
    for lab in need:
        for kind, a in calls_of[lab]:
            if kind == "gather":
                src, idx = a
                call = f"{lab}: {idx.numel():,} of {src.shape[0]:,} x {src.shape[1]}"
                check_gather(call, src, idx)
                cached_shapes["embedding_gather"].append(
                    timed_gather("dlrm_cached_train", call, src, idx))
                continue
            cache, cache_acc, idx, rows, accum = a
            call = f"{lab}: {idx.numel():,} slots into {cache.shape[0]:,} x {cache.shape[1]}"
            check_scatter(call, cache, cache_acc, idx, rows, accum)
            work, work_acc = cache.clone(), cache_acc.clone()
            valid = (idx >= 0) & (idx < cache.shape[0])
            lib_dst, lib_rows = idx[valid].long(), rows[valid]
            nbytes = scatter_bytes(cache, idx)
            row = {"kernel": "embedding_scatter", "call": call, "table_rows": cache.shape[0],
                   "n": idx.numel(), "valid": int(valid.sum()), "dim": rows.shape[1],
                   "bytes": nbytes,
                   "ms": time_ms(torch, lambda: es.embedding_scatter(
                       work, work_acc, idx, rows, accum), flush),
                   "plain_ms": time_ms(torch, lambda: ref.embedding_scatter_ref(
                       work, work_acc, idx, rows, accum), flush),
                   "library_ms": time_ms(torch, lambda: work.index_copy_(0, lib_dst, lib_rows),
                                         flush),
                   "library_call": "index_copy_ of the rows only, valid indices "
                                   "selected beforehand",
                   "bound_ms": nbytes / peak * 1e3}
            cached_shapes["embedding_scatter"].append(row)
            emit("kernel_shape", path="dlrm_cached_train", **row)
            del work, work_acc, lib_dst, lib_rows
    del cached_calls, calls_of
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6c. full-width serving through the cached tier ----------------------
    reset_counts()
    t0 = time.perf_counter()
    crep = csess.serve_embeddings(num_requests=N_REQUESTS, max_batch=MAX_BATCH,
                                  head="dlrm", check_exact=True)
    wall = time.perf_counter() - t0
    cached_serve_launches = counts()
    s = crep.summary
    emit("cached_serve", arch=ARCH, store=s["store"], head="dlrm",
         weights="trained through the cached tier", requests=N_REQUESTS,
         max_batch=MAX_BATCH, windows=int(s["windows"]), qps=s["qps"],
         latency_p50_ms=s["latency_p50_ms"], latency_p99_ms=s["latency_p99_ms"],
         serve_wall_s=s["wall_s"], total_wall_s=wall, exact=s["exact"],
         max_abs_diff=s["max_abs_diff"], read_horizon=True,
         **{k: s.get(k) for k in ("cache_hit_rate", "cache_hits", "cache_misses",
                                  "cache_admissions", "cache_evictions", "h2d_bytes",
                                  "d2h_bytes", "h2d_bursts", "h2d_copy_ms",
                                  "retrieve_ms", "plan_ms")},
         launches=cached_serve_launches)
    if s["exact"] != 1 or s["store"] != "frozen-cached":
        raise SystemExit(f"the cached tier did not serve the master exactly: {s}")
    if crep.results.shape != (N_REQUESTS,) or not np.isfinite(crep.results).all():
        raise SystemExit("served logits are not finite of shape (requests,)")
    # the same master served again with the pack wire mode: the same bits
    reset_counts()
    prep = csess.serve_embeddings(num_requests=N_REQUESTS, max_batch=MAX_BATCH,
                                  head="dlrm", sparse_comm="pack", check_exact=True)
    cached_pack_serve_launches = counts()
    ps = prep.summary
    emit("cached_serve_pack", arch=ARCH, store=ps["store"], sparse_comm=ps["sparse_comm"],
         requests=N_REQUESTS, max_batch=MAX_BATCH, qps=ps["qps"],
         latency_p50_ms=ps["latency_p50_ms"], latency_p99_ms=ps["latency_p99_ms"],
         exact=ps["exact"], max_abs_diff=ps["max_abs_diff"],
         same_results_as_off=bool(np.array_equal(prep.results, crep.results)),
         **{f"{k}_pack": ps.get(k) for k in ("wire_bytes", "idx_bytes", "h2d_bytes")},
         **{f"{k}_off": s.get(k) for k in ("wire_bytes", "idx_bytes", "h2d_bytes")},
         launches=cached_pack_serve_launches)
    if ps["exact"] != 1 or ps["sparse_comm"] != "pack":
        raise SystemExit(f"the cached tier did not serve exactly under pack: {ps}")
    del csess, crep, prep
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6d. every cache policy on the card replays the host tier -------------
    policy_runs = []
    for parch in POLICY_ARCHS:
        pkw = dict(mode="nestpipe", global_batch=POLICY_BATCH, n_micro=N_MICRO, seed=0)
        init = clone_state(Session.from_arch(parch, **pkw).state)
        host = Session.from_arch(parch, store="host", **pkw)
        host.state = clone_state(init)
        hrep = host.train(POLICY_STEPS)
        for pol in CACHE_POLICIES:
            csess = Session.from_arch(parch, store="cached", cache_rows=POLICY_CACHE_ROWS,
                                      cache_policy=pol, **pkw)
            csess.state = clone_state(init)
            prep = csess.train(POLICY_STEPS)
            m = prep.stats.store_metrics
            same = (prep.stats.losses == hrep.stats.losses
                    and torch.equal(csess.state.table.rows, host.state.table.rows)
                    and torch.equal(csess.state.table.accum, host.state.table.accum))
            policy_runs.append({
                "arch": parch, "policy": pol, "equal_to_host_tier": same,
                "cache_hit_rate": prep.summary.get("cache_hit_rate"),
                "cache_hit_rate_steady": prep.summary.get("cache_hit_rate_steady"),
                **{k: m[k] for k in ("cache_evictions", "cache_admissions", "h2d_bursts",
                                     "d2h_bursts", "cache_hits", "cache_misses")}})
            if not same:
                raise SystemExit(f"{parch} under {pol} differs from the host tier")
            if m["cache_evictions"] == 0:
                raise SystemExit(f"{parch} under {pol} evicted nothing")
        del init, host, hrep, csess, prep
    emit("cache_policies", cache_rows=POLICY_CACHE_ROWS, global_batch=POLICY_BATCH,
         steps=POLICY_STEPS, runs=policy_runs)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6e. the async stage executor at full width ---------------------------
    # -- 6f. the sparse-comm modes on the evicting cache, sync and async ------
    # each run as in 6a (one warm-up step, TIER_STEPS counted, seed 0), then
    # its losses and the rows and adagrad state of every touched key against
    # 6a's synchronous run of its tier (6f: of the evicting cache), bit for
    # bit (pack included); int8 reports its largest loss deviation from it
    race_log = []
    race_gate = threading.Event()

    def race_retrieve_start(w):
        if w == RACE_WINDOW and not race_gate.wait(timeout=120):
            raise RuntimeError(f"commit {RACE_COMMIT} was never submitted")
        race_log.append(("retrieve", w))

    def race_commit_submit(epoch):
        race_log.append(("commit_submit", epoch))
        if epoch == RACE_COMMIT:
            race_gate.set()

    race_hooks = {"retrieve_start": race_retrieve_start,
                  "commit_submit": race_commit_submit}
    side_keys = ("step_p50_ms", "step_p99_ms", "samples_per_s", "stage_host_ms_per_step",
                 "h2d_bytes", "d2h_bytes", "h2d_gb_per_s", "d2h_gb_per_s", "wire_bytes",
                 "idx_bytes", "buffer_sync_launches", "host_alloc_in_counted_steps")
    path_launches = {}
    exec_runs = {"async": [], "comm": []}
    for m, fn in tier_patches:
        setattr(HostStore, m, fn)
    try:
        for run, store, kw in ASYNC_RUNS + COMM_RUNS:
            comm_init = SparseComm.__init__
            if run == INT8_SYNC_ALL:
                SparseComm.__init__ = lambda self, mode=None, **ckw: comm_init(
                    self, mode, **{**ckw, "min_sync_p": 1.0})
            try:
                tsess, losses, row = tier_run(run, store, capture=False,
                                              hooks=race_hooks if "race" in run else None,
                                              **kw)
            finally:
                SparseComm.__init__ = comm_init
            ref_run = "cached-evicting" if "sparse_comm" in kw else store
            ref_losses, ref_rows, ref_accum, ref_row = sync_ref[ref_run]
            table = tsess.state.table
            same = {"losses": losses == ref_losses,
                    "rows": torch.equal(table.rows[keys_t], ref_rows),
                    "accum": torch.equal(table.accum[keys_t], ref_accum)}
            del table
            rec = {"run": run, "store": store, **kw, "sync_run": ref_run,
                   "equal_to_sync_run": same,
                   **{k: row.get(k) for k in side_keys},
                   **{k: row.get(k) for k in row if k.startswith(("async_repairs",
                                                                   "comm_rows"))},
                   "sync": {k: ref_row.get(k) for k in side_keys}}
            if kw.get("sparse_comm") == "int8":
                rec["max_loss_dev_from_off"] = max(abs(a - b) for a, b in
                                                   zip(losses, ref_losses))
                if not all(np.isfinite(losses)):
                    raise SystemExit(f"the {run} run's losses are not finite")
                if not row.get("comm_rows_synced"):
                    raise SystemExit(f"the {run} run synced no row selectively: {row}")
                if run == INT8_SYNC_ALL and row.get("comm_rows_deferred") != 0:
                    raise SystemExit(f"the {run} run deferred rows: {row}")
            elif not all(same.values()):
                raise SystemExit(f"the {run} run differs from 6a's {ref_run} run: {same}")
            if "race" in run:
                r = race_log.index(("retrieve", RACE_WINDOW))
                rec["race"] = {
                    "commits_submitted_before_gated_retrieve": sorted(
                        e for k, e in race_log[:r] if k == "commit_submit"),
                    "log": race_log[:r + 1]}
                if ("commit_submit", RACE_COMMIT) not in race_log[:r]:
                    raise SystemExit(f"the forced race did not happen: {race_log}")
                if row["buffer_sync_launches"] <= TIER_STEPS - 1 \
                        or not row.get("async_repairs_deferred"):
                    raise SystemExit(f"the forced race ran no deferred repairs: {row}")
            exec_runs["comm" if "sparse_comm" in kw else "async"].append(rec)
            path_launches[run] = row["launches"]
            if args.profile and run in ("host-async", "cached-async"):
                # 4 more steps, beside 6a's synchronous tier_profile lines
                marker["on"] = True
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    tsess.train(4)
                    torch.cuda.synchronize()
                    span = time.perf_counter() - t0
                marker["on"] = False
                emit_profile(prof, "tier_profile", span, window="tier_steady",
                             run=run, steps=4)
                del prof
            del tsess
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for m, fn in real_tier.items():
            setattr(HostStore, m, fn)
    emit("async_stages", arch=ARCH, global_batch=TRAIN_BATCH, steps=1 + TIER_STEPS,
         touched_keys=keys_t.numel(), runs=exec_runs["async"])
    off = sync_ref["cached-evicting"][3]
    emit("sparse_comm", arch=ARCH, global_batch=TRAIN_BATCH, steps=1 + TIER_STEPS,
         runs=exec_runs["comm"],
         off={k: off.get(k) for k in side_keys},
         pack_over_off={k: next(r[k] for r in exec_runs["comm"]
                               if r["run"] == "cached-evicting-pack") / off[k]
                        for k in ("wire_bytes", "idx_bytes", "h2d_bytes", "d2h_bytes")
                        if off.get(k)})
    del sync_ref, keys_t, exec_runs
    gc.collect()
    torch.cuda.empty_cache()

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
    batches = []
    for _ in range(CONSISTENCY_STEPS):
        b = transform(next(stream))
        b.pop("raw_keys")
        batches.append(stage_to_device(b, dev))

    def reference_run(step_fn, start, batches):
        state = clone_state(start)
        with torch.no_grad():
            for b in batches:
                state, _ = step_fn(state, b)
        return state

    ref_state = reference_run(ref_step, init, batches)
    ref_twice = same_bits(ref_state, reference_run(ref_step, init, batches))

    def gap(a, b):
        parts = [a.table.rows - b.table.rows, a.table.accum - b.table.accum]
        parts += [a.dense[k] - b.dense[k] for k in a.dense]
        return max(float(x.abs().max()) for x in parts)

    gaps = {mode: gap(r.state, ref_state) for mode, r in finals.items()}
    gaps["nestpipe_vs_serial"] = gap(finals["nestpipe"].state, finals["serial"].state)
    emit("consistency", arch=ARCH + " (reduced)", steps=CONSISTENCY_STEPS,
         max_abs_diff_to_reference=gaps,
         reference_same_bits_twice=ref_twice,
         nestpipe_equals_reference_bit_for_bit=same_bits(finals["nestpipe"].state, ref_state),
         longest_key_run=longest_key_run(batches), segment_rowsum_chunk=sr.CHUNK,
         losses={m: r.stats.losses for m, r in finals.items()})
    if not ref_twice:
        raise SystemExit("the reference trainer gave other bits on a second run")
    if max(gaps["nestpipe"], gaps["serial"], gaps["nestpipe_vs_serial"]) > 1e-5:
        raise SystemExit(f"nestpipe/serial differ from the reference: {gaps}")
    if gaps["async"] <= 1e-6:
        raise SystemExit(f"async did not diverge from the reference: {gaps}")

    del base, init, finals, ref_state, stream, batches
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8. HSTU attention kernels against their plain versions -----------
    hworst = {"hstu_attention_fwd": 0.0, "hstu_attention_bwd": 0.0}

    def check_hstu(label, q, k, v, do, causal=True, chunk=None, backward=True):
        """Kernel forward (and backward) against the plain versions, within
        HSTU_RTOL of each output's sum of magnitudes + HSTU_ATOL, and the
        same bits on a second run; compared ``chunk`` batch rows at a
        time."""
        out = ha.hstu_attention_fwd(q, k, v, causal)
        grads = ha.hstu_attention_bwd(q, k, v, do, causal) if backward else ()
        if not (torch.equal(out, ha.hstu_attention_fwd(q, k, v, causal)) and all(
                torch.equal(a, b) for a, b in
                zip(grads, ha.hstu_attention_bwd(q, k, v, do, causal)))):
            raise SystemExit(f"hstu_attention is not deterministic at {label}")
        step = chunk or q.shape[0]
        for b0 in range(0, q.shape[0], step):
            sl = slice(b0, b0 + step)
            qs, ks, vs, dos = q[sl], k[sl], v[sl], do[sl]
            out_mag, grad_mags = ref.hstu_attention_magnitudes(qs, ks, vs, dos, causal)
            pairs = [("hstu_attention_fwd", out[sl], ref.hstu_attention_ref(qs, ks, vs, causal),
                      out_mag)]
            if backward:
                pairs += [("hstu_attention_bwd", g_[sl], w_, m_) for g_, w_, m_ in zip(
                    grads, ref.hstu_attention_bwd_ref(qs, ks, vs, dos, causal), grad_mags)]
            for kname, got, want, mag in pairs:
                err = (got - want).abs()
                if not bool((err <= HSTU_RTOL * mag + HSTU_ATOL).all()):
                    raise SystemExit(f"{kname} beyond its bound at {label}: "
                                     f"{float(err.max())}")
                hworst[kname] = max(hworst[kname], float(err.max()))
            del pairs, out_mag, grad_mags

    def hstu_inputs(b, t, h, dqk, dv, strided=True):
        if strided:  # the layer's q, k, v: column slices of one tensor
            mixed = torch.empty((b, t, h, 2 * dqk + 2 * dv), device=dev).normal_(generator=g)
            _, v, q, k = torch.split(mixed, [dv, dv, dqk, dqk], dim=-1)
        else:
            q, k = (torch.empty((b, t, h, dqk), device=dev).normal_(generator=g)
                    for _ in range(2))
            v = torch.empty((b, t, h, dv), device=dev).normal_(generator=g)
        return q, k, v, torch.empty((b, t, h, dv), device=dev).normal_(generator=g)

    hedge = []
    for t in (1, 33, 256, 1024):
        for dqk, dv in ((128, 128), (16, 8), (48, 96)):
            for causal in (True, False):
                check_hstu(f"T={t} dqk={dqk} dv={dv} causal={causal}",
                           *hstu_inputs(2, t, 2, dqk, dv), causal=causal)
                hedge.append(f"T={t},dqk={dqk},dv={dv},causal={causal},strided")
        check_hstu(f"T={t} contiguous", *hstu_inputs(2, t, 2, 128, 128, strided=False))
        hedge.append(f"T={t},dqk=dv=128,contiguous")
    # head dims below the MMA's k of 8 (zero-padded), a ragged last tile
    for t in (65, 1024):
        for causal in (True, False):
            check_hstu(f"T={t} dqk=5 dv=3 causal={causal}", *hstu_inputs(2, t, 2, 5, 3),
                       causal=causal)
            hedge.append(f"T={t},dqk=5,dv=3,causal={causal},strided")
    torch.cuda.synchronize()
    emit("hstu_kernel_edges", cases=hedge, max_abs_err=dict(hworst),
         tolerance=f"|kernel - plain| <= {HSTU_RTOL} x each output's sum of "
                   f"magnitudes + {HSTU_ATOL}; the same bits on two runs")

    # -- 9. full-width HSTU training -----------------------------------------
    hcfg = HSTU_INDUSTRIAL_ONE_CARD
    harch = ArchSpec("hstu-industrial", "recsys", hcfg,
                     get_arch("hstu-industrial").reduced)
    hwl = assemble_workload(harch, hcfg, device=dev, mode="nestpipe",
                            npcfg=NestPipeConfig(fwp_microbatches=N_MICRO,
                                                 bucket_slack=SLACK),
                            global_batch=HSTU_BATCH)
    hsess = Session.from_workload(hwl, seed=0)
    hdims = hwl.engine.dims(hwl.batch_shapes["keys"][0][1:], N_MICRO)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hrows = hsess.state.table.rows
    torch.cuda.synchronize()
    emit("hstu_init", seconds=round(time.perf_counter() - t0, 3),
         config={k: getattr(hcfg, k) for k in ("d_model", "n_layers", "n_heads",
                                               "seq_len", "compute_dtype")},
         tables={t.name: t.vocab_size for t in hcfg.tables},
         table_rows=hrows.shape[0], dim=hrows.shape[1],
         table_gb=round(hrows.numel() * 4 / 1e9, 3),
         dense_params=sum(p.numel() for p in hsess.state.dense.values()),
         dims={"L": hdims.l_local, "U": hdims.u_max, "C": hdims.cap,
               "K": hdims.buffer_cap, "N": hdims.n_micro},
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del hrows
    hsess.train(1)  # unchecked warm-up step
    torch.cuda.synchronize()

    # two steps with the first call of each kernel kept: the attention
    # forward and backward (copies with the same strides; every call
    # counted) and, as on the DLRM path, the embedding kernels' calls
    seen = {"fwd": 0, "bwd": 0}
    kept = {}
    real_fwd, real_bwd = ha.hstu_attention_fwd, ha.hstu_attention_bwd

    def strided_copies(*xs):
        """Copies that keep each view's strides: q, k and v are column
        slices of one tensor, whose storage is copied once."""
        storages = {}
        out = []
        for x in xs:
            st = x.untyped_storage()
            if st.data_ptr() not in storages:
                storages[st.data_ptr()] = st.clone()
            out.append(torch.empty(0, dtype=x.dtype, device=x.device).set_(
                storages[st.data_ptr()], x.storage_offset(), x.size(), x.stride()))
        return out

    def fwd_spy(q, k, v, causal=True):
        seen["fwd"] += 1
        if "fwd" not in kept:
            kept["fwd"] = (*strided_copies(q, k, v), causal)
        return real_fwd(q, k, v, causal)

    def bwd_spy(q, k, v, do, causal=True):
        seen["bwd"] += 1
        if "bwd" not in kept:
            kept["bwd"] = (*strided_copies(q, k, v), do.clone(), causal)
        return real_bwd(q, k, v, do, causal)

    ha.hstu_attention_fwd, ha.hstu_attention_bwd = fwd_spy, bwd_spy
    try:
        hcaptured = capture_calls(hsess)
    finally:
        ha.hstu_attention_fwd, ha.hstu_attention_bwd = real_fwd, real_bwd
    n_layers = hcfg.n_layers
    if seen != {"fwd": 2 * 2 * n_layers * N_MICRO, "bwd": 2 * n_layers * N_MICRO}:
        raise SystemExit(f"two HSTU steps made {seen} attention calls")
    # the embedding kernels at this path's shapes (D = 512, K = 393,216 rows,
    # f32 retrieve and buffer rows, bf16 assembly), while the master lives
    hshapes = check_and_time("hstu_train", hcaptured, hsess.state.table)
    del hcaptured
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    hrep = hsess.train(HSTU_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hstu_launches = counts()
    s = hrep.summary
    samples_per_s = HSTU_BATCH * HSTU_STEPS / wall
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("hstu_train", arch=f"hstu-industrial (vocabularies / {HSTU_ROW_CUT:g})",
         mode="nestpipe",
         global_batch=HSTU_BATCH, n_micro=N_MICRO, bucket_slack=SLACK,
         steps=HSTU_STEPS, losses=hrep.stats.losses, overflow_max=s["overflow_max"],
         samples_per_s=samples_per_s, tokens_per_s=samples_per_s * hcfg.seq_len,
         wall_s=wall, step_ms=[x * 1e3 for x in hrep.stats.step_times],
         step_p50_ms=s["p50_step_s"] * 1e3, step_p99_ms=s["p99_step_s"] * 1e3,
         mean_input_wait_ms=s["mean_input_wait_s"] * 1e3,
         stage_host_ms={k: s[k] for k in ("plan_ms", "retrieve_ms", "commit_ms")},
         launches=hstu_launches, max_memory_allocated_gb=peak_gb,
         device_memory_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    if not all(np.isfinite(hrep.stats.losses)) or len(hrep.stats.losses) != HSTU_STEPS:
        raise SystemExit(f"HSTU losses are not {HSTU_STEPS} finite values")
    if s["overflow_max"] != 0:
        raise SystemExit(f"HSTU routing overflowed: {s['overflow_max']}")
    if peak_gb * 1e9 >= torch.cuda.get_device_properties(0).total_memory:
        raise SystemExit(f"HSTU peak memory {peak_gb} GB does not fit the card")
    hstu_want = {"embedding_gather": (1 + 3 * N_MICRO) * HSTU_STEPS,
                 "segment_rowsum": (N_MICRO + 1) * HSTU_STEPS,
                 "buffer_sync": HSTU_STEPS - 1, "embedding_scatter": HSTU_STEPS,
                 # each layer's forward runs again in the backward (per-layer remat)
                 "hstu_attention_fwd": 2 * n_layers * N_MICRO * HSTU_STEPS,
                 "hstu_attention_bwd": n_layers * N_MICRO * HSTU_STEPS,
                 "flash_attention_wgmma": 0, "flash_attention_simple": 0}
    if hstu_launches != hstu_want:
        raise SystemExit(f"HSTU launches {hstu_launches} != {hstu_want}")
    if hstu_launches["hstu_attention_fwd"] != HSTU_FWD_CALLS_PER_STEP * HSTU_STEPS:
        raise SystemExit(f"{hstu_launches['hstu_attention_fwd']} forward calls in "
                         f"{HSTU_STEPS} steps, not {HSTU_FWD_CALLS_PER_STEP} a step")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            hsess.train(2)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "hstu_train_profile", span, steps=2)
        del prof
    del hsess, hwl, hrep
    gc.collect()
    torch.cuda.empty_cache()

    # the captured main-path calls, on the card alone now: checked and timed
    peak_fp32 = peak_flops_fp32(torch, name)
    hrows_out = {}
    q, k, v, causal = kept["fwd"]
    check_hstu("main-path forward call", q, k, v, torch.zeros_like(v), causal, chunk=16,
               backward=False)
    fwd_ops, _ = hstu_work(q, v.shape[-1], causal)
    fwd_bytes = 4 * (q.numel() + k.numel() + 2 * v.numel())  # q, k, v read; out written
    hrows_out["hstu_attention_fwd"] = {
        "ms": time_ms(torch, lambda: ha.hstu_attention_fwd(q, k, v, causal), flush),
        "plain_ms": time_ms(torch, lambda: ref.hstu_attention_ref(q, k, v, causal), flush),
        "operations": fwd_ops, "bytes": fwd_bytes,
        "tf32_mma_operations": hstu_fwd_mma_ops(q, v.shape[-1], causal)}
    fwd_row = hrows_out["hstu_attention_fwd"]
    fwd_row["tf32_mma_tflops"] = fwd_row["tf32_mma_operations"] / fwd_row["ms"] / 1e9
    fwd_row["tf32_peak_share"] = fwd_row["tf32_mma_tflops"] * 1e12 / tf32_flops(name)
    q, k, v, do, causal = kept["bwd"]
    check_hstu("main-path backward call", q, k, v, do, causal, chunk=16)
    _, bwd_ops = hstu_work(q, v.shape[-1], causal)
    # q, k, v, dO read; dq, dk, dv written
    bwd_bytes = 4 * (2 * (q.numel() + k.numel() + v.numel()) + do.numel())
    hrows_out["hstu_attention_bwd"] = {
        "ms": time_ms(torch, lambda: ha.hstu_attention_bwd(q, k, v, do, causal), flush),
        "plain_ms": time_ms(torch, lambda: ref.hstu_attention_bwd_ref(q, k, v, do, causal),
                            flush),
        "operations": bwd_ops, "bytes": bwd_bytes}
    for kname, row in hrows_out.items():
        by_ops = row["operations"] / peak_fp32 * 1e3
        by_bytes = row["bytes"] / peak * 1e3
        row.update(shape=list(q.shape), dv=v.shape[-1], causal=causal,
                   bound_ms=max(by_ops, by_bytes),
                   bound_by="operations" if by_ops >= by_bytes else "bytes",
                   peak_fp32_flops=peak_fp32, achieved_tflops=row["operations"]
                   / row["ms"] / 1e9, tf32x3_bound_ms=row["operations"] * 3
                   / tf32_flops(name) * 1e3, library_ms=None)
        emit("kernel_shape", path="hstu_train", kernel=kname, **row)
    del kept, q, k, v, do, flush
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10. consistency at hstu-reduced -------------------------------------
    def hstu_gaps(sparse_lr=None, adam_eps=None):
        """Per mode, the gap to the reference trainer after
        CONSISTENCY_STEPS steps from one state, at the configuration's own
        step sizes unless ``sparse_lr`` and ``adam_eps`` are given."""
        opt_cfg = OptimizerConfig() if adam_eps is None else OptimizerConfig(eps=adam_eps)
        kw = dict(reduced=True, global_batch=16, n_micro=N_MICRO, seed=1, opt_cfg=opt_cfg)
        runs = {}
        for mode in ("nestpipe", "serial", "async"):
            runs[mode] = Session.from_arch("hstu-industrial", mode=mode, **kw)
            if sparse_lr is not None:
                runs[mode].workload.engine.sparse_lr = sparse_lr
        first = runs["nestpipe"]
        init = clone_state(first.state)
        finals = {}
        for mode, run in runs.items():
            run.state = clone_state(init)
            finals[mode] = run.train(CONSISTENCY_STEPS)
        rwl = first.workload
        ref_step = build_reference_step(make_loss_fn(rwl.cfg), first.optimizer,
                                        constant_lr(first.opt_cfg.lr, dev), N_MICRO,
                                        sparse_lr=rwl.engine.sparse_lr)
        transform = make_cluster_transform(N_MICRO, rwl.npcfg.clustering)
        stream = resolve_stream(rwl, first.seed)
        batches = [stage_to_device({"keys": transform(next(stream))["keys"]}, dev)
                   for _ in range(CONSISTENCY_STEPS)]
        ref_state = reference_run(ref_step, init, batches)
        ref_twice = same_bits(ref_state, reference_run(ref_step, init, batches))

        def two(a, b):
            parts = [a.table.rows - b.table.rows] + [a.dense[k] - b.dense[k] for k in a.dense]
            accum = (a.table.accum - b.table.accum).abs() / (1 + b.table.accum.abs())
            return {"rows_dense": max(float(x.abs().max()) for x in parts),
                    "accum_rel": float(accum.max())}

        gaps = {mode: two(r.state, ref_state) for mode, r in finals.items()}
        gaps["nestpipe_vs_serial"] = two(finals["nestpipe"].state, finals["serial"].state)
        return {"sparse_lr": rwl.engine.sparse_lr, "adam_eps": first.opt_cfg.eps,
                "max_diff_to_reference": gaps, "reference_same_bits_twice": ref_twice,
                "nestpipe_equals_reference_bit_for_bit": same_bits(finals["nestpipe"].state,
                                                                   ref_state),
                "longest_key_run": longest_key_run(batches), "segment_rowsum_chunk": sr.CHUNK,
                "losses": {m: r.stats.losses for m, r in finals.items()}}

    hstu_runs = {"default_step_sizes": hstu_gaps(),
                 "small_step_sizes": hstu_gaps(**HSTU_SMALL_STEPS)}
    emit("hstu_consistency", arch="hstu-industrial (reduced)", steps=CONSISTENCY_STEPS,
         **hstu_runs, bounds="rows and dense within 1e-5, accum within 1e-4 of "
         "1 + accum; async more than 1e-6 from the reference")
    for label, run in hstu_runs.items():
        if not run["reference_same_bits_twice"]:
            raise SystemExit(f"the HSTU reference gave other bits on a second run at the {label}")
        hgaps = run["max_diff_to_reference"]
        for key in ("nestpipe", "serial", "nestpipe_vs_serial"):
            if hgaps[key]["rows_dense"] > 1e-5 or hgaps[key]["accum_rel"] > 1e-4:
                raise SystemExit(f"HSTU {key} differs from the reference at the "
                                 f"{label}: {hgaps}")
        if hgaps["async"]["rows_dense"] <= 1e-6:
            raise SystemExit(f"HSTU async did not diverge at the {label}: {hgaps}")

    # -- 11. release --------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    emit("release", memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
         memory_reserved_gb=torch.cuda.memory_reserved() / 1e9)

    # -- 12. flash_attention against its plain version -----------------------
    fworst = {"flash_attention_wgmma bfloat16": 0.0, "flash_attention_simple float32": 0.0,
              "flash_attention_simple bfloat16": 0.0}

    def check_flash(label, q, k, v, causal, chunk=None, simple=False):
        """The kernel ``fa.variant`` picks (or the general one when
        ``simple``) against the plain version within
        ref.flash_attention_bound, ``chunk`` batch rows at a time, the same
        bits on a second run, and only that kernel's counter moved. Returns
        the kernel's name."""
        kind = "simple" if simple else fa.variant(q, k, v)
        kname = f"flash_attention_{kind}"
        fn = fa.flash_attention_simple if simple else fa.flash_attention
        before = (fa.launches_wgmma, fa.launches_simple)
        got = fn(q, k, v, causal)
        if not torch.equal(got, fn(q, k, v, causal)):
            raise SystemExit(f"{kname} is not deterministic at {label}")
        moved = (fa.launches_wgmma - before[0], fa.launches_simple - before[1])
        if moved != ((2, 0) if kind == "wgmma" else (0, 2)):
            raise SystemExit(f"{label}: {kname} chosen, but launches moved by {moved}")
        step = chunk or q.shape[0]
        for b0 in range(0, q.shape[0], step):
            sl = slice(b0, b0 + step)
            want = ref.flash_attention_ref(q[sl], k[sl], v[sl], causal)
            err = (got[sl].float() - want.float()).abs()
            bound = ref.flash_attention_bound(q[sl], k[sl], v[sl], want, causal)
            if not bool((err <= bound).all()):
                raise SystemExit(f"{kname} beyond its bound at {label}: "
                                 f"{float(err.max())} (bound there "
                                 f"{float(bound.flatten()[int((err - bound).argmax())])})")
            key = f"{kname} {str(q.dtype).removeprefix('torch.')}"
            fworst[key] = max(fworst[key], float(err.max()))
            del want, err, bound
        return kname

    def flash_inputs(b, tq, tk, h, kv, hd, dtype):
        return [torch.empty((b, t, n, hd), device=dev).normal_(generator=g).to(dtype)
                for t, n in ((tq, h), (tk, kv), (tk, kv))]

    fedge = []
    head_dims = (16, 64, 80, 128, 160, 192, 256)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for t in (1, 33, 64, 257, 2048):
            for hd in head_dims:
                for kv in (4, 1):  # H/KV 1 and 4
                    for causal in (True, False):
                        case = (f"T={t} hd={hd} H/KV={4 // kv} causal={causal} {dname}",
                                *flash_inputs(1, t, t, 4, kv, hd, dtype), causal)
                        kname = check_flash(*case)
                        want = ("flash_attention_wgmma" if dtype == torch.bfloat16
                                and hd in fa.WGMMA_HEAD_DIMS else "flash_attention_simple")
                        if kname != want:
                            raise SystemExit(f"{case[0]} went to {kname}, not {want}")
                        if kname == "flash_attention_wgmma" and t in (33, 257):
                            check_flash(*case, simple=True)  # the general kernel in bf16
            fedge.append(f"{dname} T={t} hd in {head_dims} H/KV in {{1,4}} causal and not"
                         + (" (wgmma; the general kernel too at T 33, 257)"
                            if dtype == torch.bfloat16 else ""))
        for causal in (False, True):
            case = (f"Tq=33 Tk=100 causal={causal} {dname}",
                    *flash_inputs(2, 33, 100, 4, 1, 160, dtype), causal)
            check_flash(*case)
            if dtype == torch.bfloat16:
                check_flash(*case, simple=True)
        fedge.append(f"{dname} Tq=33 Tk=100 hd=160 H/KV=4 causal and not")
        # strided views: column slices of one wider tensor, 16-byte loads off
        # (in bf16, copied for the wgmma kernel), and 16-byte aligned as a
        # fused projection makes them (read in place)
        for off in (3, 8):
            wide = torch.empty((2, 100, 4, 3 * 160 + off), device=dev).normal_(
                generator=g).to(dtype)
            kname = check_flash(f"strided {dname} offset {off}", wide[..., off:off + 160],
                                wide[..., off + 160:off + 320], wide[..., off + 320:off + 480],
                                True)
            fedge.append(f"{dname} strided q, k, v (T=100, hd=160, {off} elements in): "
                         f"{kname}")
    # the layout never picks the kernel: the same values give the same bits
    # in a contiguous layout and in each layout TMA cannot describe (copied)
    base = flash_inputs(2, 100, 100, 4, 1, 160, torch.bfloat16)

    def off_alignment(x):
        flat = torch.zeros(x.numel() + 3, dtype=x.dtype, device=dev)
        return flat[3:].view(x.shape).copy_(x)  # 6 bytes off 16-byte alignment

    def stride_164(x):
        return torch.zeros((*x.shape[:-1], 164), dtype=x.dtype, device=dev)[..., :160].copy_(x)

    def heads_outside(x):
        return x.transpose(1, 2).contiguous().transpose(1, 2)

    for causal in (True, False):
        want_bits = fa.flash_attention(*base, causal)
        for layout in (off_alignment, stride_164, heads_outside):
            views = [layout(x) for x in base]
            if not all(torch.equal(a, b) for a, b in zip(views, base)):
                raise SystemExit(f"the {layout.__name__} views do not hold the same values")
            if fa.tma_ok(views[0]):
                raise SystemExit(f"the {layout.__name__} view is one TMA describes")
            before = fa.launches_wgmma
            got = fa.flash_attention(*views, causal)
            if fa.launches_wgmma != before + 1:
                raise SystemExit(f"the {layout.__name__} layout did not run the wgmma kernel")
            if not torch.equal(got, want_bits):
                raise SystemExit(f"the {layout.__name__} layout changed the bits "
                                 f"(causal={causal})")
            fedge.append(f"bf16 T=100 hd=160 {layout.__name__} (causal={causal}): the "
                         "contiguous layout's bits through the wgmma kernel")
    del base, want_bits, got, views
    try:
        x = torch.zeros((1, 8, 2, 16), device=dev)
        dispatch.flash_attention(x, x.cpu(), x)
    except ValueError:
        fedge.append("a CUDA tensor beside a CPU tensor raises")
    else:
        raise SystemExit("flash_attention took a CPU tensor beside CUDA ones")
    torch.cuda.synchronize()
    emit("flash_kernel_edges", cases=fedge, max_abs_err=dict(fworst),
         tolerance="|kernel - plain| <= 1e-5 M + 1e-7 (f32) or 2**-8 M + one bf16 ulp of "
                   "the plain output (bf16), M = sum_j w_ij |v_j|; the same bits on two runs")

    # -- 13. main path: full-width stablelm-12b serving -----------------------
    from torch.autograd import DeviceType

    lm = Session.from_arch(LM_ARCH, seed=0)
    lwl, lcfg = lm.workload, lm.workload.cfg
    n_lm_layers = lcfg.n_layers
    decode_steps = LM_GEN - 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, ltable = lm.lm_weights()  # the draw the serves below read
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    weights_gb = sum(p_.numel() * p_.element_size() for p_ in params.values()) / 1e9
    # warm-up serve, keeping the first and the last layer's flash_attention
    # inputs and the gathers of two lookups: the prefill's (the f32 master
    # retrieve, then two bf16 assembly gathers) and the first decode step's;
    # the master is kept by reference, every other tensor copied
    kept_flash, flash_calls = {}, [0]
    kept_gather, gather_calls = [], [0]
    real_flash, real_gather = dispatch.flash_attention, dispatch.gather_rows
    gather_labels = [f"{step} {part}" for step in ("prefill", "decode")
                     for part in ("retrieve", "assemble-1", "assemble-2")]

    def flash_spy(q, k, v, causal=True):
        i = flash_calls[0]
        flash_calls[0] += 1
        if i in (0, n_lm_layers - 1):
            kept_flash[i] = (q.clone(), k.clone(), v.clone(), causal)
        return real_flash(q, k, v, causal)

    def gather_spy(rows, idx):
        if gather_calls[0] < len(gather_labels):
            kept_gather.append((rows if rows is ltable.rows else rows.clone(), idx.clone()))
        gather_calls[0] += 1
        return real_gather(rows, idx)

    dispatch.flash_attention, dispatch.gather_rows = flash_spy, gather_spy
    try:
        t0 = time.perf_counter()
        warm = lm.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        dispatch.flash_attention, dispatch.gather_rows = real_flash, real_gather
    if flash_calls[0] != n_lm_layers:
        raise SystemExit(f"the warm-up serve made {flash_calls[0]} flash calls")
    if gather_calls[0] != 3 * (1 + decode_steps):
        raise SystemExit(f"the warm-up serve made {gather_calls[0]} gathers")
    if kept_gather[0][0] is not ltable.rows or kept_gather[3][0] is not ltable.rows:
        raise SystemExit("the LM lookups did not retrieve from the master")
    # the gathers at this path's shapes (the master's 5,120-wide f32 rows,
    # then bf16 rows), bit-exact against the plain version and timed
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    lm_gathers = []
    for label, (src, idx) in zip(gather_labels, kept_gather):
        check_gather(f"lm_serve {label}", src, idx)
        lm_gathers.append(timed_gather("lm_serve", label, src, idx))
    del kept_gather, src, idx
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lrep = lm.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN)
    torch.cuda.synchronize()
    lm_launches = counts()
    lm_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ls = lrep.summary
    emit("lm_serve", arch=LM_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN,
         reduced="batch 8, prompt 2048, 32 generated (decode_32k: batch 128 x 32,768)",
         config={k: getattr(lcfg, k) for k in ("n_layers", "d_model", "d_ff",
                                               "vocab_size", "param_dtype",
                                               "compute_dtype")},
         heads=[lcfg.attention.n_heads, lcfg.attention.n_kv_heads, lcfg.attention.head_dim],
         weights_gb=weights_gb, table_gb=ltable.rows.numel() * 4 / 1e9,
         prefill_s=ls["prefill_s"], prompt_tokens_per_s=LM_BATCH * LM_PROMPT / ls["prefill_s"],
         decode_s=ls["decode_s"], decode_step_ms=ls["decode_s"] / decode_steps * 1e3,
         generated_tokens_per_s=ls["tokens_per_s"], weights_draw_s=draw_s,
         warmup_serve_s=warm_s,
         launches=lm_launches, max_memory_allocated_gb=lm_peak_gb,
         sample_tokens=ls["sample_tokens"])
    lm_want = {k: 0 for k in KERNELS}
    # every prefill call through the main-path kernel
    lm_want.update(embedding_gather=3 * (1 + decode_steps), flash_attention_wgmma=n_lm_layers)
    if lm_launches != lm_want:  # 3 gathers a lookup: master, then two assembly
        raise SystemExit(f"LM serving launches {lm_launches} != {lm_want}")
    if not np.array_equal(lrep.tokens, warm.tokens):
        raise SystemExit("two serves of the same weights generated different tokens")
    if lrep.tokens.shape != (LM_BATCH, LM_GEN) or not (
            (0 <= lrep.tokens) & (lrep.tokens < lcfg.vocab_size)).all():
        raise SystemExit(f"generated tokens {lrep.tokens.shape} are not vocabulary ids")

    # the prefill once more with the kernel, and once with the plain
    # attention (here only; the port has no switch), on the serve's prompts
    toks = np.random.default_rng(lm.seed).integers(0, lcfg.vocab_size,
                                                   size=(LM_BATCH, LM_PROMPT))
    with torch.inference_mode():
        keys = lwl.spec.scramble(torch.as_tensor(toks.astype(np.int32), device=dev))
        emb, _ = lwl.engine.lookup_from_master(ltable, keys)
        logits_k, cache = lwl.bundle.prefill(params, emb, cache_len=LM_PROMPT + LM_GEN)
        del cache
        dispatch.flash_attention = ref.flash_attention_ref
        try:
            logits_p, cache = lwl.bundle.prefill(params, emb, cache_len=LM_PROMPT + LM_GEN)
        finally:
            dispatch.flash_attention = real_flash
        del cache, emb
    scale = float(logits_p.abs().max())
    logit_gap = float((logits_k - logits_p).abs().max())
    greedy_agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    first_tok = logits_k.argmax(-1).cpu().numpy()
    emit("lm_prefill_vs_plain", max_abs_logit=scale, max_logit_gap=logit_gap,
         gap_share=logit_gap / scale, bound_share=LM_LOGIT_RTOL,
         greedy_tokens_agreeing=greedy_agree,
         first_token_equals_serve=bool(np.array_equal(first_tok, lrep.tokens[:, 0])))
    if not np.isfinite(logits_k.cpu().numpy()).all() or logit_gap > LM_LOGIT_RTOL * scale:
        raise SystemExit(f"prefill logits with the kernel are {logit_gap} from the plain "
                         f"attention's (max |logit| {scale})")
    if not np.array_equal(first_tok, lrep.tokens[:, 0]):
        raise SystemExit("the prefill's argmax is not the serve's first token")
    del logits_k, logits_p

    if args.profile:  # the prefill, then 8 decode steps from its cache
        from torch.profiler import ProfilerActivity, profile

        with torch.inference_mode():
            emb, _ = lwl.engine.lookup_from_master(ltable, keys)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                logits, cache = lwl.bundle.prefill(params, emb,
                                                   cache_len=LM_PROMPT + LM_GEN)
                tok = logits.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            emit_profile(prof, "lm_prefill_profile", span, prefills=1)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(8):
                    emb, _ = lwl.engine.lookup_from_master(
                        ltable, lwl.spec.scramble(tok[:, None]))
                    logits, cache = lwl.bundle.decode_step(params, emb, cache)
                    tok = logits.argmax(-1).to(torch.int32)
                    tok.cpu()  # as serve() reads each token back
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            events = prof.key_averages()
            emit_profile(prof, "lm_decode_profile", span, steps=8,
                         device_kernels_per_step=sum(
                             e.count for e in events if e.device_type != DeviceType.CPU) / 8,
                         host_op_events_per_step=sum(  # nested operators included
                             e.count for e in events if e.device_type == DeviceType.CPU
                             and e.key.startswith("aten::")) / 8)
            del prof, logits, cache, emb
    del lm, params, ltable, lwl, warm, lrep
    gc.collect()
    torch.cuda.empty_cache()

    # the captured calls: checked at full shape, and timed beside the plain
    # version, SDPA (the yardstick; the port never calls it) and the bound
    frows = []
    for layer, (q, k, v, causal) in sorted(kept_flash.items()):
        if fa.variant(q, k, v) != "wgmma":
            raise SystemExit(f"the prefill's layer {layer} call is not the wgmma kernel's")
        check_flash(f"main-path layer {layer}", q, k, v, causal, chunk=1)
        check_flash(f"main-path layer {layer}, general kernel", q, k, v, causal, chunk=1,
                    simple=True)
        ops, nbytes = flash_work(q, k, causal)
        by_ops, by_bytes = ops / bf16_flops(name) * 1e3, nbytes / peak * 1e3
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row = {"kernel": "flash_attention_wgmma", "call": f"prefill layer {layer}",
               "shape": list(q.shape), "kv_heads": k.shape[2], "causal": causal,
               "dtype": str(q.dtype).removeprefix("torch."), "operations": ops,
               "bytes": nbytes,
               "ms": time_ms(torch, lambda: fa.flash_attention(q, k, v, causal), flush),
               "simple_ms": time_ms(torch, lambda: fa.flash_attention_simple(q, k, v, causal),
                                    flush),
               "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal),
                                   flush),
               "library_ms": time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal,
                                                         enable_gqa=True), flush),
               "library_call": "scaled_dot_product_attention(is_causal, enable_gqa) on "
                               "(B, H, T, hd) views",
               "bound_ms": max(by_ops, by_bytes),
               "bound_by": "operations" if by_ops >= by_bytes else "bytes"}
        row["achieved_tflops"] = ops / row["ms"] / 1e9
        row["simple_tflops"] = ops / row["simple_ms"] / 1e9
        frows.append(row)
        emit("kernel_shape", path="lm_serve", **row)
        del qt, kt, vt
    del kept_flash, flush
    gc.collect()
    torch.cuda.empty_cache()

    # -- 14. kernels line and the result -----------------------------------
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        by_path = {"dlrm_train": train_launches[kname],
                   "dlrm_serve": serve_launches[kname],
                   "dlrm_host_train": host_train_launches[kname],
                   "dlrm_cached_train": cached_train_launches[kname],
                   "dlrm_cached_serve": cached_serve_launches[kname],
                   "dlrm_cached_pack_serve": cached_pack_serve_launches[kname],
                   **{path: path_launches[run][kname]
                      for run, path in TIER_PATHS.items()},
                   "hstu_train": hstu_launches[kname],
                   "lm_serve": lm_launches[kname]}
        for path in RUNS_ON[kname]:
            if by_path[path] == 0:
                raise SystemExit(f"{kname} was not launched on the {path} path")
        if kname.startswith("flash_attention_"):
            row = frows[0]
            ms_key = "ms" if kname == "flash_attention_wgmma" else "simple_ms"
            entry = {
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": max(v for k, v in fworst.items() if k.startswith(kname)),
                "ms": row[ms_key], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "ms_of": "one call at the main-path shape " + str(row["shape"])
                         + f" over {row['kv_heads']} kv heads, bf16, causal",
                "calls_per_serve": lm_launches[kname],
                "last_layer": {k: frows[-1][k] for k in (ms_key, "plain_ms", "library_ms",
                                                         "bound_ms")},
            }
        elif kname in hrows_out:
            row = hrows_out[kname]
            entry = {
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": hworst[kname], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None,
                "ms_of": "one call at the main-path shape " + str(row["shape"]),
                "calls_per_step": hstu_want[kname] // HSTU_STEPS,
                "tf32x3_bound_ms": row["tf32x3_bound_ms"],
            }
            entry.update({k: row[k] for k in ("tf32_mma_tflops", "tf32_peak_share") if k in row})
        else:
            rows = shapes[kname]
            entry = {
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": worst[kname],
                "ms": sum(x["ms"] for x in rows),
                "plain_ms": sum(x["plain_ms"] for x in rows),
                "bound_ms": sum(x["bound_ms"] for x in rows),
                "bound_by": "bytes",
                "library_ms": (None if any(x["library_ms"] is None for x in rows)
                               else sum(x["library_ms"] for x in rows)),
                "ms_of": "one dlrm-ctr training step: " + ", ".join(x["call"] for x in rows),
                "hstu_train_step": {
                    **{k: (None if any(x[k] is None for x in hshapes[kname])
                           else sum(x[k] for x in hshapes[kname]))
                       for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                    "calls": [x["call"] for x in hshapes[kname]]},
            }
        if kname == "embedding_gather":
            times = ("ms", "plain_ms", "library_ms", "bound_ms")
            entry["serve_window"] = {k: sum(x[k] for x in serve_shapes) for k in times}
            # one LM serve: the prefill's lookup and decode_steps decode-step
            # lookups, each timed at the first decode step's calls
            prefill = {k: sum(x[k] for x in lm_gathers[:3]) for k in times}
            decode_step = {k: sum(x[k] for x in lm_gathers[3:]) for k in times}
            entry["lm_serve"] = {
                **{k: prefill[k] + decode_steps * decode_step[k] for k in times},
                "prefill": prefill, "decode_step": decode_step,
                "calls": f"the prefill's {', '.join(x['call'] for x in lm_gathers[:3])}; "
                         f"{decode_steps} x the first decode step's"}
        if kname in cached_shapes:  # the cached tier's calls (phase 6b)
            calls = cached_shapes[kname]
            entry["dlrm_cached_train_calls"] = {
                **{k: sum(x[k] for x in calls)
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                "calls": [x["call"] for x in calls]}
        if kname == "segment_rowsum":  # the op's parts per step: sort, starts, sum, combine
            for step, calls in ((entry, rows), (entry["hstu_train_step"], hshapes[kname])):
                step["parts_ms"] = {k: sum(x["parts_ms"][k] for x in calls)
                                    for k in calls[0]["parts_ms"]}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def emit_profile(prof, phase, span, window=None, **fields):
    """Device busy time and idle share of a profiled span, and its top
    kernels and host ops. Busy time is the union of the intervals of the
    profiler's device-side events (kernels, copies, sets); an operator that
    launched a kernel carries the kernel's time too and is not counted
    again. ``window`` names a host-side ``record_function`` range: the span
    is then that range, and only device time inside it counts."""
    from torch.autograd import DeviceType

    lo, hi = float("-inf"), float("inf")
    marks = [e for e in prof.events()
             if window and e.name == window and e.device_type == DeviceType.CPU]
    if marks:
        lo, hi = marks[0].time_range.start, marks[0].time_range.end
        span = (hi - lo) / 1e6
    # device work: every device-side event but the range's own annotation
    on_device = [e for e in prof.events()
                 if e.device_type != DeviceType.CPU and not (window and e.name == window)]
    busy_us, end = 0.0, float("-inf")
    per_kernel = {}
    for e in on_device:
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b > a:
            n, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (n + 1, us + b - a)
    for a, b in sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                       for e in on_device):
        if b > end and b > a:
            busy_us += b - max(a, end)
            end = b
    events = prof.key_averages()
    device = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    emit(phase, **fields, wall_ms=span * 1e3, device_busy_ms=busy_us / 1e3,
         device_idle_share=1 - busy_us / 1e3 / (span * 1e3),
         device_kernels_ms=sum(us for _, us in per_kernel.values()) / 1e3,
         host_torch_ops_ms=sum(e.self_cpu_time_total for e in host) / 1e3,
         top_device=[{"name": k[:70], "count": n, "ms": us / 1e3}
                     for k, (n, us) in device[:12]],
         top_host=[{"name": e.key[:70], "count": e.count,
                    "ms": e.self_cpu_time_total / 1e3} for e in host[:10]])


if __name__ == "__main__":
    sys.exit(main())
