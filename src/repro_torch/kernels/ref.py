"""Plain PyTorch versions of the ported kernels: what the CPU path runs and
what each kernel is held against on the card."""
from __future__ import annotations

import torch


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with out-of-range (negative or ``>= R``) -> zero row:
    the contract of ``kernels/embedding_gather.py``."""
    n_rows = table.shape[0]
    valid = (idx >= 0) & (idx < n_rows)
    rows = table.index_select(0, idx.clamp(0, n_rows - 1))
    return torch.where(valid[:, None], rows, rows.new_zeros(()))


def segment_rowsum_ref(grads: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """f32 ``(num_segments, D)`` sums of ``grads`` rows by ``ids``; ids
    outside ``[0, num_segments)`` are dropped: the contract of
    ``kernels/segment_rowsum.py``. On the CPU ``index_add_`` adds in input
    order, as the kernel does; on the card it uses atomics."""
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments, grads.shape[-1]), dtype=torch.float32,
                      device=grads.device)
    return out.index_add_(0, ids[keep].long(), grads[keep].to(torch.float32))


def segment_rowsum_chunked_ref(grads: torch.Tensor, ids: torch.Tensor,
                               num_segments: int, chunk: int) -> torch.Tensor:
    """``segment_rowsum_ref`` summed in the CUDA kernel's order: each
    segment's rows, in input order, cut into chunks of ``chunk``; each chunk
    summed in order from zero, then the chunk sums added in chunk order. A
    segment of at most ``chunk`` rows gives ``segment_rowsum_ref``'s bits
    (on the CPU, whose ``index_add_`` adds in input order)."""
    keep = (ids >= 0) & (ids < num_segments)
    seg = ids[keep].long()
    rows = grads[keep].to(torch.float32)
    order = torch.sort(seg, stable=True).indices  # input order within a segment
    seg, rows = seg[order], rows[order]
    first = torch.searchsorted(seg, seg, right=False)  # each segment's first position
    rank = torch.arange(seg.numel(), device=seg.device) - first
    # chunks numbered segment-major, in chunk order within a segment
    key = seg * (seg.numel() // chunk + 1) + rank // chunk
    uniq, chunk_of = torch.unique(key, sorted=True, return_inverse=True)
    sums = torch.zeros((uniq.numel(), grads.shape[-1]), dtype=torch.float32,
                       device=grads.device).index_add_(0, chunk_of, rows)
    out = torch.zeros((num_segments, grads.shape[-1]), dtype=torch.float32,
                      device=grads.device)
    return out.index_add_(0, uniq // (seg.numel() // chunk + 1), sums)


def buffer_sync_ref(active_rows: torch.Tensor, active_accum: torch.Tensor,
                    prefetch_rows: torch.Tensor, prefetch_accum: torch.Tensor,
                    src: torch.Tensor):
    """``(rows, accum)``: the active row and accumulator at ``src[i]`` where
    ``src[i] < Ka`` (negative ``src`` wraps to ``src + Ka``, then clamps at
    0), else the prefetch ones: the contract of ``kernels/buffer_sync.py``."""
    ka = active_rows.shape[0]
    hit = src < ka
    safe = torch.clamp(src.long(), max=ka - 1)
    safe = torch.where(safe < 0, safe + ka, safe).clamp(min=0)
    rows = torch.where(hit[:, None], active_rows[safe], prefetch_rows)
    accum = torch.where(hit, active_accum[safe], prefetch_accum)
    return rows, accum


def embedding_scatter_ref(table: torch.Tensor, table_accum: torch.Tensor,
                          idx: torch.Tensor, rows: torch.Tensor,
                          accum: torch.Tensor) -> None:
    """``table[idx] = rows`` and ``table_accum[idx] = accum`` in place for
    every in-range ``idx`` (distinct); the rest are dropped: the contract of
    ``kernels/embedding_scatter.py``."""
    valid = (idx >= 0) & (idx < table.shape[0])
    dst = idx[valid].long()
    table[dst] = rows[valid]
    table_accum[dst] = accum[valid]


def hstu_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True) -> torch.Tensor:
    """``O[b,i,h] = sum_j m(i,j) silu(scale q_i . k_j) / T v_j`` in f32, with
    ``scale = 1/sqrt(dqk)`` and ``m`` the key-range (and causal) mask, for
    q, k (B, T, H, dqk) and v (B, T, H, dv): the contract of
    ``kernels/hstu_attention.py``. Differentiable by autograd."""
    t, dqk = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * dqk ** -0.5
    a = torch.nn.functional.silu(s) * (1.0 / t)
    if causal:
        a = torch.where(_causal_mask(t, q.device), a, a.new_zeros(()))
    return torch.einsum("bhqk,bkhd->bqhd", a, v.to(torch.float32)).to(q.dtype)


def hstu_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           do: torch.Tensor, causal: bool = True):
    """``(dq, dk, dv)`` of ``hstu_attention_ref`` for the output gradient
    ``do``, written out: with ``z = scale q . k``, ``dA = dO v``,
    ``dS = m dA / T silu'(z) scale`` and ``silu'(z) = sig(z) (1 + z (1 -
    sig(z)))``, ``dq = dS k``, ``dk = dS^T q`` and ``dv = (m silu(z) / T)^T dO``."""
    return _hstu_attention_bwd(q, k, v, do, causal, torch.einsum)


def tf32_round(x: torch.Tensor, ties: str = "even") -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest,
    ties to even as ``cvt.rn.tf32.f32`` rounds (the CUDA backward's split)
    or away from zero as ``cvt.rna.tf32.f32`` does (``ties="away"``);
    infinities and NaNs unchanged."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    if ties == "away":
        half = 0x1000
    elif ties == "even":  # half an ulp, less one unless the kept last bit is odd
        half = 0x0FFF + ((bits >> 13) & 1)
    else:
        raise ValueError(f"ties is 'even' or 'away', got {ties!r}")
    rounded = (bits + half) & -0x2000  # drop the 13 bits below TF32's last
    return torch.where(torch.isfinite(x), rounded, bits).view(torch.float32)


def _tf32_product(passes: int, ties: str):
    """``product(equation, a, b)``: an einsum of two f32 operands as the CUDA
    kernels' tensor cores take it: both operands in TF32, rounded with
    ``ties`` (``tf32_round``; the kernels' is "even"), in ``passes``: 3 is
    split precision, the kernels' (``hi lo' + lo hi' + hi hi'`` with ``lo =
    tf32(x - hi)``), 1 plain TF32 (``hi hi'``). Each product of two TF32
    values is exact in f32 and the sums are f32."""

    def product(eq, a, b):
        a_hi, b_hi = tf32_round(a, ties), tf32_round(b, ties)
        if passes == 1:
            return torch.einsum(eq, a_hi, b_hi)
        a_lo, b_lo = tf32_round(a - a_hi, ties), tf32_round(b - b_hi, ties)
        return (torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_lo, b_hi)
                + torch.einsum(eq, a_hi, b_hi))

    return product


def hstu_attention_fwd_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = True, passes: int = 3,
                            ties: str = "even") -> torch.Tensor:
    """``hstu_attention_ref`` with both products (S = q k^T and O = A v) as
    the CUDA forward's tensor cores take them (``_tf32_product``). A model
    of the kernel's arithmetic for the CPU, not a kernel: the weights A stay
    f32."""
    product = _tf32_product(passes, ties)
    t, dqk = q.shape[1], q.shape[-1]
    q, k, v = (x.to(torch.float32) for x in (q, k, v))
    s = product("bqhd,bkhd->bhqk", q, k) * dqk ** -0.5
    a = torch.nn.functional.silu(s) * (1.0 / t)
    if causal:
        a = torch.where(_causal_mask(t, q.device), a, a.new_zeros(()))
    return product("bhqk,bkhd->bqhd", a, v)


def hstu_attention_bwd_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, causal: bool = True, passes: int = 3,
                            ties: str = "even"):
    """``hstu_attention_bwd_ref`` with every product as the CUDA backward's
    tensor cores take it (``_tf32_product``). A model of the kernels'
    arithmetic for the CPU, not a kernel: the elementwise part stays f32."""
    return _hstu_attention_bwd(q, k, v, do, causal, _tf32_product(passes, ties))


def _hstu_attention_bwd(q, k, v, do, causal, product):
    """The backward of ``hstu_attention_bwd_ref`` in f32 with each of its
    five products ``product(equation, a, b)``."""
    t, dqk = q.shape[1], q.shape[-1]
    scale, inv_t = dqk ** -0.5, 1.0 / t
    q, k, v, do = (x.to(torch.float32) for x in (q, k, v, do))
    z = product("bqhd,bkhd->bhqk", q, k) * scale
    sig = torch.sigmoid(z)
    keep = _causal_mask(t, q.device) if causal else torch.ones(
        (t, t), dtype=torch.bool, device=q.device)
    zero = z.new_zeros(())
    a = torch.where(keep, z * sig * inv_t, zero)
    da = product("bqhd,bkhd->bhqk", do, v)
    ds = torch.where(keep, da * inv_t * (sig * (1 + z * (1 - sig))) * scale, zero)
    return (product("bhqk,bkhd->bqhd", ds, k), product("bhqk,bqhd->bkhd", ds, q),
            product("bhqk,bqhd->bkhd", a, do))


def _causal_mask(t: int, device) -> torch.Tensor:
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def hstu_attention_magnitudes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              do: torch.Tensor, causal: bool = True):
    """The sums of magnitudes that bound how far two f32 evaluations of
    ``hstu_attention`` (forward; dq, dk, dv) may differ when they add in
    different orders: each output's sum of ``|term|``, with every score's
    own rounding (``scale |q| . |k|``) carried through ``|silu'| <= 1.1``
    and ``|silu''| <= 0.5``. A check holds ``|a - b| <= rtol * magnitude
    + atol``. Returns ``(out_mag, (dq_mag, dk_mag, dv_mag))``."""
    t, dqk = q.shape[1], q.shape[-1]
    scale, inv_t = dqk ** -0.5, 1.0 / t
    qa, ka, va, da = (x.to(torch.float32).abs() for x in (q, k, v, do))
    z = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    zm = torch.einsum("bqhd,bkhd->bhqk", qa, ka) * scale
    keep = _causal_mask(t, q.device) if causal else torch.ones(
        (t, t), dtype=torch.bool, device=q.device)
    zero = z.new_zeros(())
    a_mag = torch.where(keep, (torch.nn.functional.silu(z).abs() + 1.1 * zm) * inv_t, zero)
    p = torch.einsum("bqhd,bkhd->bhqk", da, va)
    ds_mag = torch.where(keep, (1.1 * p + 0.5 * p * zm) * inv_t * scale, zero)
    return (torch.einsum("bhqk,bkhd->bqhd", a_mag, va),
            (torch.einsum("bhqk,bkhd->bqhd", ds_mag, ka),
             torch.einsum("bhqk,bqhd->bkhd", ds_mag, qa),
             torch.einsum("bhqk,bqhd->bkhd", a_mag, da)))


def _softmax_weights(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """f32 ``(B, H, Tq, Tk)`` weights ``softmax_j(scale q_i . k_j)`` with
    ``scale = 1/sqrt(hd)``, the scores taken in f32 from the inputs' values
    and set to -1e30 at keys after the query when ``causal`` (positions from
    0 on both sides); k has H heads already."""
    tq, tk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * hd ** -0.5
    if causal:
        s = torch.where(_causal_mask_rect(tq, tk, q.device), s, s.new_full((), -1e30))
    return torch.softmax(s, dim=-1)


def _causal_mask_rect(tq: int, tk: int, device) -> torch.Tensor:
    return (torch.arange(tq, device=device)[:, None]
            >= torch.arange(tk, device=device)[None, :])


def repeat_kv(k: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, heads, hd): query head h reads kv head
    h // (heads // KV), as ``repro.models.layers._repeat_kv`` repeats."""
    kv = k.shape[2]
    if heads % kv:
        raise ValueError(f"{heads} query heads are not a multiple of {kv} kv heads")
    return k if heads == kv else k.repeat_interleave(heads // kv, dim=2)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Softmax attention for q ``(B, Tq, H, hd)`` and k, v ``(B, Tk, KV, hd)``
    (``H % KV == 0``; kv heads repeated into query groups): f32 scores
    scaled by ``1/sqrt(hd)``, causal entries -1e30, f32 softmax times f32 v,
    cast to ``q.dtype``. The contract of ``kernels/flash_attention.py``, and
    the math of ``repro.kernels.ref.flash_attention_ref`` with the scores
    in f32 (that oracle rounds bf16 scores before it lifts them)."""
    h = q.shape[2]
    w = _softmax_weights(q, repeat_kv(k, h), causal)
    return torch.einsum("bhqk,bkhd->bqhd", w,
                        repeat_kv(v, h).to(torch.float32)).to(q.dtype)


def flash_attention_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          plain: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """How far the kernel's output may lie from ``plain`` (this module's
    output on the same inputs), per element, in f32. f32 inputs: ``1e-5 M
    + 1e-7`` with ``M = sum_j w_ij |v_j|`` (the same terms added in another
    order). bf16 inputs: ``2**-8 M`` plus one bf16 ulp of ``plain`` (the
    kernel rounds each weight to bf16 before the product, a relative 2**-9
    of M, as the TPU kernel does; then both outputs round to bf16)."""
    h = q.shape[2]
    w = _softmax_weights(q, repeat_kv(k, h), causal)
    mag = torch.einsum("bhqk,bkhd->bqhd", w, repeat_kv(v, h).to(torch.float32).abs())
    if q.dtype == torch.float32:
        return 1e-5 * mag + 1e-7
    _, exp = torch.frexp(plain.to(torch.float32))
    return 2.0 ** -8 * mag + torch.ldexp(torch.ones_like(mag), exp - 8)
