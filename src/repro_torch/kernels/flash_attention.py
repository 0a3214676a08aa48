"""Softmax attention on the card: the wrapper of ``csrc/flash_attention_wgmma.cu``,
``csrc/flash_attention_tf32.cu`` and ``csrc/flash_attention.cu`` (the
forward), and of ``csrc/flash_attention_bwd_wgmma.cu``,
``csrc/flash_attention_bwd_tf32.cu`` and ``csrc/flash_attention_bwd.cu``
(the backward).

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

Three kernels compute it, chosen by ``variant`` from the inputs' type and
head dim alone (never from their layout, nor from a build or launch
error), so the same values give the same bits in every layout, as the
TPU kernel does:

- ``csrc/flash_attention_wgmma.cu`` (``"wgmma"``), the LM path (serving
  and training): bf16 at hd in ``WGMMA_HEAD_DIMS``. It reads views that a
  TMA tensor map describes (16-byte aligned bases, every stride a multiple
  of 8 elements and nested: heads inside positions inside batches) in
  place; any other view is copied into a fresh contiguous tensor first. wgmma products with
  S, P and O in registers, TMA loads into a two-stage ring, a producer
  warpgroup.
- ``csrc/flash_attention_tf32.cu`` (``"tf32x3"``), FuXi's training path:
  f32 at ``hd <= TF32X3_MAX_HEAD_DIM``, any view with a unit stride along
  hd. Both products on the TF32 tensor cores in split precision (3xTF32
  ``mma.sync``), the online softmax in the score registers.
- ``csrc/flash_attention.cu`` (``"simple"``), the general path: f32 at
  head dims above 128, bf16 outside ``WGMMA_HEAD_DIMS``, any view with a
  unit stride along hd; and ``flash_attention_simple`` for any inputs.

Inputs are bf16 or f32 strided views with a unit stride along hd and
``1 <= hd <= 256``; the output is contiguous. The CUDA libraries build at
first use (``kernels/build.py``); nothing here touches CUDA at import.

The gradient is a kernel too: ``flash_attention_bwd`` computes dq, dk and
dv from q, k, v, the output, its gradient and the row logsumexp that each
forward writes beside its output when asked, through one of three
kernels chosen by ``bwd_variant`` from the type and head dim alone (never
from the layout, nor from which forward wrote the lse):

- ``csrc/flash_attention_bwd_wgmma.cu`` (``"wgmma"``), the LM training
  path: bf16 at hd in ``WGMMA_BWD_HEAD_DIMS`` (64, 80, 128 and 160). A
  delta pass, a dq kernel over 128-row query tiles and a dk/dv kernel over
  128-row key tiles (the transposed scores, so both gradients take their A
  operand from registers), every product on wgmma with TMA loads into a
  ring and a producer warpgroup; P and dS rounded to bf16 only as A
  operands. At hd 160 the dk/dv kernel walks the queries 32 at a time (64
  below), so that dK and dV (80 registers each) fit beside the scores.
  Views TMA cannot describe (q, k, v, o or do) are copied first, as for
  the wgmma forward.
- ``csrc/flash_attention_bwd_tf32.cu`` (``"tf32x3"``), FuXi's training
  path: f32 at ``hd <= TF32X3_MAX_HEAD_DIM``. A delta pass, a dq kernel
  over 128-row query tiles and a dk/dv kernel over 128-row key tiles, every
  product on the TF32 tensor cores in split precision (3xTF32
  ``mma.sync``), each MMA chain within one 32-row step.
- ``csrc/flash_attention_bwd.cu`` (``"simple"``), the general path: f32
  above hd 128 and bf16 outside ``WGMMA_BWD_HEAD_DIMS`` (lifted to f32 as
  it is loaded), on the f32 CUDA cores; and ``flash_attention_bwd_simple``
  for any inputs.

All three sum in a fixed order with no atomics. :class:`FlashAttention` joins
forward and backward for autograd.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build

# Launches of each kernel in this process, and their sums (``launches``
# of the forward kernels, ``launches_bwd`` of the backward ones).
# Incremented only where a kernel launches, so a run can show that its path
# went through it. The backward's counts take a lock, as the gather's does.
launches_wgmma = 0
launches_tf32x3 = 0
launches_simple = 0
launches = 0
launches_bwd_wgmma = 0
launches_bwd_tf32x3 = 0
launches_bwd_simple = 0
launches_bwd = 0
_bwd_lock = threading.Lock()

MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 80, 128, 160, 192, 256)
WGMMA_BWD_HEAD_DIMS = (64, 80, 128, 160)
TF32X3_MAX_HEAD_DIM = 128
_SYMBOLS = {("tf32x3", torch.float32): ("flash_attention_tf32",
                                        "repro_flash_attention_fwd_tf32x3"),
            ("simple", torch.float32): ("flash_attention", "repro_flash_attention_fwd_f32"),
            ("simple", torch.bfloat16): ("flash_attention", "repro_flash_attention_fwd_bf16"),
            ("wgmma", torch.bfloat16): ("flash_attention_wgmma",
                                        "repro_flash_attention_fwd_wgmma"),
            ("bwd_wgmma", torch.bfloat16): ("flash_attention_bwd_wgmma",
                                            "repro_flash_attention_bwd_wgmma"),
            ("bwd_tf32x3", torch.float32): ("flash_attention_bwd_tf32",
                                            "repro_flash_attention_bwd_tf32x3"),
            ("bwd_simple", torch.float32): ("flash_attention_bwd",
                                            "repro_flash_attention_bwd_f32"),
            ("bwd_simple", torch.bfloat16): ("flash_attention_bwd",
                                             "repro_flash_attention_bwd_bf16")}
_fns = {}


def _kernel(kind: str, dtype: torch.dtype):
    fn = _fns.get((kind, dtype))
    if fn is None:
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        view = [p, i64, i64, i64]
        sizes = [i64] * 6  # B, Tq, Tk, H, KV, hd
        if kind in ("wgmma", "simple", "tf32x3"):  # q, k, v; out, lse
            args = [*view * 3, p, p, *sizes, i32, f32, p]
        else:  # the backward kernels: q, k, v, o, do; lse, delta scratch, dq, dk, dv
            args = [*view * 5, p, p, p, p, p, *sizes, i32, f32, p]
        fn = _fns[(kind, dtype)] = build.function(*_SYMBOLS[(kind, dtype)], args)
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
    """``"wgmma"`` for bf16 inputs at a head dim in ``WGMMA_HEAD_DIMS``,
    ``"tf32x3"`` for f32 inputs at ``hd <= TF32X3_MAX_HEAD_DIM``, else
    ``"simple"``: a function of the type and the head dim only, never of
    the layout. It runs on CPU tensors too."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS:
        return "wgmma"
    if q.dtype == torch.float32 and q.shape[-1] <= TF32X3_MAX_HEAD_DIM:
        return "tf32x3"
    return "simple"


def bwd_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The backward kernel ``flash_attention_bwd`` launches: ``"wgmma"``
    for bf16 inputs at a head dim in ``WGMMA_BWD_HEAD_DIMS``, ``"tf32x3"``
    for f32 inputs at ``hd <= TF32X3_MAX_HEAD_DIM``, else ``"simple"``. A
    function of the type and the head dim only, never of the layout or of
    which forward wrote the lse; it runs on CPU tensors too."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_BWD_HEAD_DIMS:
        return "wgmma"
    if q.dtype == torch.float32 and q.shape[-1] <= TF32X3_MAX_HEAD_DIM:
        return "tf32x3"
    return "simple"


def tma_ok(x: torch.Tensor) -> bool:
    """Whether a TMA tensor map describes this (B, T, heads, hd) view: a
    16-byte aligned base, every stride a multiple of 16 bytes, and nested
    (heads inside positions inside batches)."""
    if x.stride(-1) != 1 or x.data_ptr() % 16:
        return False
    sb, st, sh = _strides(x)
    if sb % 8 or st % 8 or sh % 8:
        return False
    return sh >= x.shape[-1] and st >= x.shape[2] * sh and sb >= x.shape[1] * st


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
            causal: bool, lse: bool = False):
    """The output, or ``(out, lse)`` when ``lse``: the row logsumexp,
    contiguous f32 ``(B, H, Tq)``."""
    global launches, launches_wgmma, launches_tf32x3, launches_simple
    b, tq, h, hd = q.shape
    tk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, tq, h, hd), dtype=q.dtype, device=q.device)
    rows = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) if lse else None
    if out.numel() == 0:
        return (out, rows) if lse else out
    fn = _kernel(kind, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), *_strides(q), k.data_ptr(), *_strides(k),
                 v.data_ptr(), *_strides(v), out.data_ptr(),
                 0 if rows is None else rows.data_ptr(), b, tq, tk, h, kv,
                 hd, int(causal), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({kind}) launch failed: CUDA error {err}")
    if kind == "wgmma":
        launches_wgmma += 1
    elif kind == "tf32x3":
        launches_tf32x3 += 1
    else:
        launches_simple += 1
    launches += 1
    return (out, rows) if lse else out


def _tma_views(kind: str, *xs: torch.Tensor):
    """The views as the kernel ``kind`` reads them: for a wgmma kernel a
    view TMA cannot describe is copied (never sent to another kernel)."""
    if kind != "wgmma":
        return xs
    return tuple(x if tma_ok(x) else x.clone(memory_format=torch.contiguous_format)
                 for x in xs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The contiguous ``(B, Tq, H, hd)`` output, in q's type, for CUDA q,
    k, v of one type (bf16 or f32), through the kernel ``variant`` picks;
    for the wgmma kernel, a view TMA cannot describe is read from a
    contiguous copy. No lse is written."""
    _check(q, k, v)
    kind = variant(q, k, v)
    return _launch(kind, *_tma_views(kind, q, k, v), causal)


def flash_attention_simple(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True, lse: bool = False):
    """``flash_attention`` through the general kernel whatever the inputs
    (to hold the kernels against each other and time them); ``(out,
    lse)`` when ``lse``, as ``flash_attention_lse`` returns them."""
    _check(q, k, v)
    return _launch("simple", q, k, v, causal, lse=lse)


def lse_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel ``flash_attention_lse`` launches: ``variant``'s (every
    forward kernel writes the lse when asked)."""
    return variant(q, k, v)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """``(out, lse)`` through the kernel ``lse_variant`` picks: the output,
    and the row logsumexp ``m + log d`` of the masked, scaled scores, f32
    ``(B, H, Tq)``, which the backward reads. The output has the bits that
    kernel gives without the lse; a view the wgmma kernel's TMA cannot
    describe is copied, as in ``flash_attention``."""
    _check(q, k, v)
    kind = lse_variant(q, k, v)
    return _launch(kind, *_tma_views(kind, q, k, v), causal, lse=True)


def _launch_bwd(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, causal: bool):
    """``(dq, dk, dv)`` through the backward kernel ``kind`` (``"wgmma"``,
    ``"tf32x3"`` or ``"simple"``), after the checks every kernel needs; for
    the wgmma kernel, views TMA cannot describe are read from contiguous
    copies."""
    global launches_bwd, launches_bwd_wgmma, launches_bwd_tf32x3, launches_bwd_simple
    _check(q, k, v)
    b, tq, h, hd = q.shape
    tk, kv = k.shape[1], k.shape[2]
    for name, x in (("o", o), ("do", do)):
        if x.device != q.device or x.dtype != q.dtype or tuple(x.shape) != tuple(q.shape) \
                or x.stride(-1) != 1:
            raise ValueError(f"flash_attention backward: {name} must be a "
                             f"{tuple(q.shape)} {q.dtype} view with unit stride along hd "
                             f"on {q.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    if lse.device != q.device or lse.dtype != torch.float32 \
            or tuple(lse.shape) != (b, h, tq) or not lse.is_contiguous():
        raise ValueError(f"flash_attention backward: lse must be a contiguous float32 "
                         f"{(b, h, tq)} tensor on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    dq = torch.empty((b, tq, h, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, kv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    q, k, v, o, do = _tma_views(kind, q, k, v, o, do)
    fn = _kernel(f"bwd_{kind}", q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), *_strides(q), k.data_ptr(), *_strides(k),
                 v.data_ptr(), *_strides(v), o.data_ptr(), *_strides(o),
                 do.data_ptr(), *_strides(do), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, tq, tk, h, kv, hd,
                 int(causal), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward ({kind}) launch failed: CUDA error {err}")
    with _bwd_lock:
        if kind == "wgmma":
            launches_bwd_wgmma += 1
        elif kind == "tf32x3":
            launches_bwd_tf32x3 += 1
        else:
            launches_bwd_simple += 1
        launches_bwd += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        causal: bool = True):
    """``(dq, dk, dv)``, contiguous and in q's type, of the forward for the
    output gradient ``do``, through the kernel ``bwd_variant`` picks: ``o``
    is the forward's output and ``lse`` its row logsumexp
    (``flash_attention_lse``); o and do are ``(B, Tq, H, hd)`` views with a
    unit stride along hd, of q's type."""
    return _launch_bwd(bwd_variant(q, k, v), q, k, v, o, do, lse, causal)


def flash_attention_bwd_simple(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                               causal: bool = True):
    """``flash_attention_bwd`` through the general backward kernel
    (``csrc/flash_attention_bwd.cu``) whatever the inputs, to hold the
    backward kernels against each other and time them."""
    return _launch_bwd("simple", q, k, v, o, do, lse, causal)


class FlashAttention(torch.autograd.Function):
    """The forward through the kernel ``variant`` picks, with its row
    logsumexp, saving q, k, v, the output and the lse; the backward through
    ``flash_attention_bwd``, the kernel ``bwd_variant`` picks: FuXi's f32 at
    hd 64 goes through the tf32x3 forward and backward, an LM's bf16 at hd
    64, 80, 128 or 160 (``WGMMA_BWD_HEAD_DIMS``) through the wgmma forward
    and the wgmma backward, and at the forward's other wgmma head dims (192,
    256) through the wgmma forward and the general backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True):
        out, lse = flash_attention_lse(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, ctx.causal)
        return dq, dk, dv, None
