"""HSTU pointwise attention on the card: the wrappers of ``csrc/hstu_attention.cu``.

Replaces the Pallas TPU kernel ``hstu_attention``
(``src/repro/kernels/hstu_attention.py``): for q, k ``(B, T, H, dqk)`` and
v ``(B, T, H, dv)``, ``O[b,i,h] = sum_j m(i,j) silu(q_i . k_j / sqrt(dqk))
/ T v_j``, ``m`` masking keys at or past T and, when causal, keys after
the query. The JAX layer differentiates its jnp form; here the backward
is a kernel too (a dq kernel over query tiles and a dk/dv kernel over key
tiles, both recomputing the scores), behind :class:`HSTUAttention`. The
function is bound by arithmetic: the forward runs on the f32 CUDA cores,
the backward's products on the tensor cores in split-precision TF32
(3xTF32, ``mma.sync``; ``ref.hstu_attention_bwd_tf32`` models its
arithmetic on the CPU). The source note says how each design meets that.

Inputs are f32 strided views with a unit stride along d (the layer's q, k
and v are column slices of one tensor and are not copied); outputs are
contiguous. Head dims are at most 128.

The CUDA library builds at first use (``kernels/build.py``); nothing here
touches CUDA at import.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

# Launches in this process: of the forward kernel, and of the backward
# (one dq and one dk/dv kernel each). Incremented only where the kernels
# launch, so a run can show that its path went through them.
launches_fwd = 0
launches_bwd = 0

MAX_HEAD_DIM = 128

_fns = {}


def _kernel(direction: str):
    fn = _fns.get(direction)
    if fn is None:
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        view = [p, i64, i64, i64]
        if direction == "fwd":
            args = [*view * 3, p, i64, i64, i64, i64, i64, i32, f32, f32, p]
        else:
            args = [*view * 4, p, p, p, i64, i64, i64, i64, i64, i32, f32, f32, p]
        fn = _fns[direction] = build.function(
            "hstu_attention", f"repro_hstu_attention_{direction}_f32", args)
    return fn


def _check(name: str, *xs: torch.Tensor) -> None:
    dev = xs[0].device
    if not all(x.is_cuda and x.device == dev for x in xs):
        raise ValueError(f"{name} needs every tensor on one CUDA device, got "
                         f"{[str(x.device) for x in xs]}")
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 tensors, got {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} takes (B, T, H, d) tensors, got {tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} takes views with unit stride along d, got "
                             f"strides {x.stride()}")


def _shapes(name: str, q, k, v) -> Tuple[int, int, int, int, int]:
    b, t, h, dqk = q.shape
    dv = v.shape[-1]
    if tuple(k.shape) != (b, t, h, dqk) or tuple(v.shape[:3]) != (b, t, h):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if not (0 < dqk <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM):
        raise ValueError(f"{name} takes head dims 1..{MAX_HEAD_DIM}, got "
                         f"dqk={dqk}, dv={dv}")
    return b, t, h, dqk, dv


def _view(x: torch.Tensor):
    return (x.data_ptr(), x.stride(0), x.stride(1), x.stride(2))


def hstu_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True) -> torch.Tensor:
    """The contiguous f32 ``(B, T, H, dv)`` output for CUDA q, k, v."""
    global launches_fwd
    _check("hstu_attention", q, k, v)
    b, t, h, dqk, dv = _shapes("hstu_attention", q, k, v)
    out = torch.empty((b, t, h, dv), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    fn = _kernel("fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*_view(q), *_view(k), *_view(v), out.data_ptr(), b, t, h, dqk,
                 dv, int(causal), dqk ** -0.5, 1.0 / t, stream)
    if err != 0:
        raise RuntimeError(f"hstu_attention forward launch failed: CUDA error {err}")
    launches_fwd += 1
    return out


def hstu_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, causal: bool = True):
    """``(dq, dk, dv)``, contiguous f32, of the forward for the output
    gradient ``do`` ``(B, T, H, dv)``."""
    global launches_bwd
    _check("hstu_attention backward", q, k, v, do)
    b, t, h, dqk, dv = _shapes("hstu_attention backward", q, k, v)
    if tuple(do.shape) != tuple(v.shape):
        raise ValueError(f"hstu_attention backward: do {tuple(do.shape)} is not "
                         f"the output's shape {tuple(v.shape)}")
    dq = torch.empty((b, t, h, dqk), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(dq)
    dvo = torch.empty((b, t, h, dv), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, dk, dvo
    fn = _kernel("bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*_view(q), *_view(k), *_view(v), *_view(do), dq.data_ptr(),
                 dk.data_ptr(), dvo.data_ptr(), b, t, h, dqk, dv, int(causal),
                 dqk ** -0.5, 1.0 / t, stream)
    if err != 0:
        raise RuntimeError(f"hstu_attention backward launch failed: CUDA error {err}")
    launches_bwd += 1
    return dq, dk, dvo


class HSTUAttention(torch.autograd.Function):
    """The kernel forward, and the kernel backward for autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return hstu_attention_fwd(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = hstu_attention_bwd(q, k, v, do, ctx.causal)
        return dq, dk, dv, None
