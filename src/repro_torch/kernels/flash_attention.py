"""Softmax attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``flash_attention``
(``src/repro/kernels/flash_attention.py``): for q ``(B, Tq, H, hd)`` and k,
v ``(B, Tk, KV, hd)`` with ``H % KV == 0``, ``O[b,i,h] = sum_j w_ij
v_j`` with ``w_i = softmax_j(q_i . k_j / sqrt(hd))`` over the keys
``j <= i`` when causal (positions from 0 on both sides), computed with a
running max, denominator and f32 accumulator over key tiles, ``p`` rounded
to v's type before it multiplies v, and ``acc / max(d, 1e-30)`` cast to
q's type. Query head ``h`` reads kv head ``h // (H // KV)``, so grouped
heads are never repeated in memory. The function is bound by its
products; the source note says how the design meets that (bf16 on the
tensor cores, f32 on the CUDA cores).

Inputs are bf16 or f32 strided views with a unit stride along hd and
``1 <= hd <= 256``; the output is contiguous. The CUDA library builds at
first use (``kernels/build.py``); nothing here touches CUDA at import.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# Launches of the kernel in this process. Incremented only where the
# kernel launches, so a run can show that its path went through it.
launches = 0

MAX_HEAD_DIM = 256
_SYMBOLS = {torch.float32: "repro_flash_attention_fwd_f32",
            torch.bfloat16: "repro_flash_attention_fwd_bf16"}
_fns = {}


def _kernel(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        view = [p, i64, i64, i64]
        fn = _fns[dtype] = build.function(
            "flash_attention", _SYMBOLS[dtype],
            [*view * 3, p, i64, i64, i64, i64, i64, i64, i32, f32, p])
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The contiguous ``(B, Tq, H, hd)`` output, in q's type, for CUDA q,
    k, v of one type (bf16 or f32)."""
    global launches
    dev = q.device
    if not all(x.is_cuda and x.device == dev for x in (q, k, v)):
        raise ValueError(f"flash_attention needs q, k and v on one CUDA device, "
                         f"got {[str(x.device) for x in (q, k, v)]}")
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
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
    out = torch.empty((b, tq, h, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = _kernel(q.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
                 v.data_ptr(), *v.stride()[:3], out.data_ptr(), b, tq, tk, h, kv, hd,
                 int(causal), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
