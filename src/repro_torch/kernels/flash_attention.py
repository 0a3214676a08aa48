"""Softmax attention on the card: the wrapper of ``csrc/flash_attention_wgmma.cu``
and ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``flash_attention``
(``src/repro/kernels/flash_attention.py``): for q ``(B, Tq, H, hd)`` and k,
v ``(B, Tk, KV, hd)`` with ``H % KV == 0``, ``O[b,i,h] = sum_j w_ij
v_j`` with ``w_i = softmax_j(q_i . k_j / sqrt(hd))`` over the keys
``j <= i`` when causal (positions from 0 on both sides), computed with a
running max, denominator and f32 accumulator over key tiles, ``p`` rounded
to v's type before it multiplies v, and ``acc / max(d, 1e-30)`` cast to
q's type. Query head ``h`` reads kv head ``h // (H // KV)``, so grouped
heads are never repeated in memory. The function is bound by its
products; the source notes say how each design meets that.

Two kernels compute it, chosen by ``variant`` from the inputs' type, head
dim, strides and alignment alone (never from a build or launch error):

- ``csrc/flash_attention_wgmma.cu`` (``"wgmma"``), the main path: bf16,
  hd in ``WGMMA_HEAD_DIMS``, views that a TMA tensor map describes (16-byte
  aligned bases, every stride a multiple of 8 elements and nested: heads
  inside positions inside batches). wgmma products with S, P and O in
  registers, TMA loads into a two-stage ring, a producer warpgroup.
- ``csrc/flash_attention.cu`` (``"simple"``), the general path: f32, any
  ``1 <= hd <= 256``, any view with a unit stride along hd.

Inputs are bf16 or f32 strided views with a unit stride along hd and
``1 <= hd <= 256``; the output is contiguous. The CUDA libraries build at
first use (``kernels/build.py``); nothing here touches CUDA at import.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# Launches of each kernel in this process, and their sum. Incremented only
# where a kernel launches, so a run can show that its path went through it.
launches_wgmma = 0
launches_simple = 0
launches = 0

MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 80, 128, 160, 192, 256)
_SYMBOLS = {("simple", torch.float32): ("flash_attention", "repro_flash_attention_fwd_f32"),
            ("simple", torch.bfloat16): ("flash_attention", "repro_flash_attention_fwd_bf16"),
            ("wgmma", torch.bfloat16): ("flash_attention_wgmma",
                                        "repro_flash_attention_fwd_wgmma")}
_fns = {}


def _kernel(kind: str, dtype: torch.dtype):
    fn = _fns.get((kind, dtype))
    if fn is None:
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        view = [p, i64, i64, i64]
        fn = _fns[(kind, dtype)] = build.function(
            *_SYMBOLS[(kind, dtype)],
            [*view * 3, p, i64, i64, i64, i64, i64, i64, i32, f32, p])
    return fn


def _strides(x: torch.Tensor):
    """``(sb, st, sh)`` of a (B, T, heads, hd) view, a size-1 dim's stride
    replaced by the one it would have nested inside the next (its value is
    never used to address anything)."""
    b, t, heads, hd = x.shape
    sh = x.stride(2) if heads > 1 else hd
    st = x.stride(1) if t > 1 else heads * sh
    sb = x.stride(0) if b > 1 else t * st
    return sb, st, sh


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"wgmma"`` where the main-path kernel takes these inputs (bf16, hd
    in ``WGMMA_HEAD_DIMS``, every view one that a TMA map describes), else
    ``"simple"``. A pure function of the types, head dim, strides and base
    addresses: it runs on CPU tensors too."""
    hd = q.shape[-1]
    if hd not in WGMMA_HEAD_DIMS:
        return "simple"
    for x in (q, k, v):
        if x.dtype != torch.bfloat16 or x.stride(-1) != 1 or x.data_ptr() % 16:
            return "simple"
        sb, st, sh = _strides(x)
        if sb % 8 or st % 8 or sh % 8:  # TMA: strides a multiple of 16 bytes
            return "simple"
        if not (sh >= hd and st >= x.shape[2] * sh and sb >= x.shape[1] * st):
            return "simple"
    return "wgmma"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    dev = q.device
    if not all(x.is_cuda and x.device == dev for x in (q, k, v)):
        raise ValueError(f"flash_attention needs q, k and v on one CUDA device, "
                         f"got {[str(x.device) for x in (q, k, v)]}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not k.dtype == v.dtype == q.dtype:
        raise TypeError(f"flash_attention takes q, k, v of one type, float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("flash_attention takes (B, T, heads, hd) tensors")
    b, tq, h, hd = q.shape
    tk, kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, tk, kv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} do not match")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads are not a multiple of "
                         f"{kv} kv heads")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims 1..{MAX_HEAD_DIM}, got {hd}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention takes views with unit stride along hd")
    if tk == 0 and tq > 0 and b > 0:
        raise ValueError("flash_attention needs at least one key")


def _launch(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    global launches, launches_wgmma, launches_simple
    b, tq, h, hd = q.shape
    tk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, tq, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _kernel(kind, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), *_strides(q), k.data_ptr(), *_strides(k),
                 v.data_ptr(), *_strides(v), out.data_ptr(), b, tq, tk, h, kv, hd,
                 int(causal), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({kind}) launch failed: CUDA error {err}")
    if kind == "wgmma":
        launches_wgmma += 1
    else:
        launches_simple += 1
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The contiguous ``(B, Tq, H, hd)`` output, in q's type, for CUDA q,
    k, v of one type (bf16 or f32), through the kernel ``variant`` picks."""
    _check(q, k, v)
    return _launch(variant(q, k, v), q, k, v, causal)


def flash_attention_simple(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True) -> torch.Tensor:
    """``flash_attention`` through the general kernel whatever the inputs
    (to hold the two kernels against each other and time them)."""
    _check(q, k, v)
    return _launch("simple", q, k, v, causal)
