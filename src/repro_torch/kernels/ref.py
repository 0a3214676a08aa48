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


def _flash_scores(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """f32 ``(B, H, Tq, Tk)`` scaled scores ``q_i . k_j / sqrt(hd)`` (k with
    H heads already) and the keep mask (None when nothing is masked)."""
    tq, tk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * hd ** -0.5
    return s, (_causal_mask_rect(tq, tk, q.device) if causal else None)


def _softmax_weights(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """f32 ``(B, H, Tq, Tk)`` weights ``softmax_j(scale q_i . k_j)`` with
    ``scale = 1/sqrt(hd)``, the scores taken in f32 from the inputs' values
    and set to -1e30 at keys after the query when ``causal`` (positions from
    0 on both sides); k has H heads already."""
    s, keep = _flash_scores(q, k, causal)
    if keep is not None:
        s = torch.where(keep, s, s.new_full((), -1e30))
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


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            causal: bool = True) -> torch.Tensor:
    """The row logsumexp ``m + log d`` of the scaled scores, -1e30 at keys
    after the query when ``causal``: f32 ``(B, H, Tq)``, what the general
    forward kernel writes beside its output for the backward."""
    s, keep = _flash_scores(q, repeat_kv(k, q.shape[2]), causal)
    if keep is not None:
        s = torch.where(keep, s, s.new_full((), -1e30))
    return torch.logsumexp(s, dim=-1)


def _f32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 ``x`` to f32, rounded toward zero (truncated)."""
    f = x.to(torch.float32)
    over = f.to(torch.float64).abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma(acc: torch.Tensor, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One m16n8k8 TF32 ``mma.sync`` as this model takes it: ``acc`` plus
    the exact sum of the 8 products of TF32 ``a`` and ``b`` (``eq``),
    truncated to f32 once. The tensor cores add truncating, not rounding;
    how many bits they carry inside the sum is not modelled, so the model is
    the mildest form of the truncation (at most one ulp of the result an
    MMA, always toward zero)."""
    exact = acc.to(torch.float64) + torch.einsum(eq, a.to(torch.float64), b.to(torch.float64))
    return _f32_toward_zero(exact)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a b + c`` rounded once (``fmaf``)."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def _mma_tf32(acc: torch.Tensor, small, eq: str, a: torch.Tensor, b: torch.Tensor,
              passes: int, ties: str):
    """One k step of 3xTF32 (or one-pass) MMAs, each operand split into TF32
    hi and lo with ``ties`` (``tf32_round``): small += hi.lo' + lo.hi', then
    acc += hi.hi' (``mma_tf32x3_apart``); with small None all three into
    acc (``mma_tf32x3``). ``passes`` 1 keeps hi.hi' alone. Each MMA is
    ``_mma``. Returns (acc, small)."""
    a_hi, b_hi = tf32_round(a, ties), tf32_round(b, ties)
    if passes == 3:
        a_lo, b_lo = tf32_round(a - a_hi, ties), tf32_round(b - b_hi, ties)
        x = acc if small is None else small
        x = _mma(_mma(x, eq, a_hi, b_lo), eq, a_lo, b_hi)
        acc, small = (x, None) if small is None else (acc, x)
    elif passes != 1:
        raise ValueError(f"passes is 1 or 3, got {passes}")
    return _mma(acc, eq, a_hi, b_hi), small


def flash_attention_fwd_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True, passes: int = 3, ties: str = "even",
                             chains: str = "short"):
    """``(out, lse)``: ``flash_attention_ref`` and ``flash_attention_lse_ref``
    as the CUDA ``tf32x3`` forward computes them. A model of the kernel's
    arithmetic for the CPU, not a kernel:

    - every product is a chain of m16n8k8 MMAs (``_mma``: products exact,
      the sum truncated to f32 at each MMA) over 8 columns of hd (S = q k^T)
      or 8 keys (P v) at a time, each operand split into TF32 hi and lo
      with ``ties`` (``tf32_round``), in ``passes``: 3 is split precision
      (``hi lo'``, ``lo hi'``, then ``hi hi'``), 1 one TF32 pass (``hi hi'``);
    - the keys come 32 a step with an online softmax in f32: the running max
      ``m`` from -1e30, ``alpha = exp(m_old - m_new)``, ``p = exp(z - m_new)``
      (z the scaled score, -1e30 where masked); each of a row's four lanes
      keeps its part of the denominator (keys ``8 nb + 2 t`` and ``+ 1`` of
      the step, added in order, then ``d alpha + sum`` by one fma), the four
      added as ``(d0 + d1) + (d2 + d3)`` at the end;
    - ``chains="short"`` (the kernel): S's small products run in a chain of
      their own, added to the hi.hi' sum at the end, each 8 columns' hi.hi'
      products are summed from zero and added to S by an f32 add, and each
      step's P v is summed from zero (12 MMAs) and added to O by
      ``fma(O, alpha, .)``;
      ``chains="long"`` (the first form, which drifted on values of one
      sign): one chain per S entry, and O scaled by alpha then carrying
      every MMA of every step;
    - the output is ``O / max(d, 1e-30)``, the lse ``m + log d``.

    A warp's skipped causal steps are not skipped here: they add exact
    zeros with alpha 1, which changes nothing."""
    if chains not in ("short", "long"):
        raise ValueError(f"chains is 'short' or 'long', got {chains!r}")
    h, tq, tk, hd = q.shape[2], q.shape[1], k.shape[1], q.shape[-1]
    qt, kt, vt = (x.to(torch.float32).transpose(1, 2)
                  for x in (q, repeat_kv(k, h), repeat_kv(v, h)))  # (B, H, T, hd)

    def product(acc, small, eq, a, b):
        return _mma_tf32(acc, small, eq, a, b, passes, ties)

    s = _tf32_scores(qt, kt, passes, ties, chains, round_steps=True)
    keep = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        keep = _causal_mask_rect(tq, tk, q.device)
    z = torch.where(keep, s * hd ** -0.5, s.new_full((), -1e30))

    steps = -(-tk // 32)
    pad = steps * 32 - tk
    z = torch.nn.functional.pad(z, (0, pad), value=-1e30)
    vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
    m = z.new_full(z.shape[:3], -1e30)
    d = z.new_zeros((*z.shape[:3], 4))  # a row's four lanes t
    acc = qt.new_zeros(qt.shape[:3] + (hd,))
    for step in range(steps):
        zs = z[..., 32 * step:32 * step + 32]
        m_new = torch.maximum(m, zs.amax(-1))
        alpha = torch.exp(m - m_new)
        m = m_new
        p = torch.exp(zs - m[..., None])
        lanes = p.reshape(*p.shape[:3], 4, 4, 2)  # (nb, t, e & 1)
        part = torch.zeros_like(d)
        for nb in range(4):
            for e in range(2):
                part = part + lanes[..., nb, :, e]
        d = _fma(d, alpha[..., None], part)
        vs = vt[..., 32 * step:32 * step + 32, :]
        if chains == "short":
            pv = acc.new_zeros(acc.shape)
            for kc in range(0, 32, 8):
                pv, _ = product(pv, None, "bhqk,bhkd->bhqd", p[..., kc:kc + 8],
                                vs[..., kc:kc + 8, :])
            acc = _fma(acc, alpha[..., None], pv)
        else:
            acc = acc * alpha[..., None]
            for kc in range(0, 32, 8):
                acc, _ = product(acc, None, "bhqk,bhkd->bhqd", p[..., kc:kc + 8],
                                 vs[..., kc:kc + 8, :])
    den = (d[..., 0] + d[..., 1]) + (d[..., 2] + d[..., 3])
    out = acc / den.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2), m + torch.log(den)


def _tf32_scores(a: torch.Tensor, b: torch.Tensor, passes: int, ties: str,
                 chains: str, round_steps: bool = False) -> torch.Tensor:
    """``a b^T`` of (B, H, M, hd) and (B, H, N, hd) as ``product_abt`` takes
    it: a chain of MMAs (``_mma_tf32``) over 8 columns of hd at a time; with
    ``chains="short"`` the small products in a chain of their own, added to
    the hi.hi' chain at the end (``kApart``), and with ``round_steps`` too
    each 8 columns' hi.hi' products from zero, added by an f32 add
    (``kRoundSteps``); else one chain an entry."""
    shape = (*a.shape[:3], b.shape[2])
    s = a.new_zeros(shape)
    small = a.new_zeros(shape) if chains == "short" else None
    for c in range(0, a.shape[-1], 8):
        if round_steps and small is not None:
            part, small = _mma_tf32(a.new_zeros(shape), small, "bhid,bhjd->bhij",
                                    a[..., c:c + 8], b[..., c:c + 8], passes, ties)
            s = s + part
        else:
            s, small = _mma_tf32(s, small, "bhid,bhjd->bhij", a[..., c:c + 8],
                                 b[..., c:c + 8], passes, ties)
    return s if small is None else s + small


def _group_sum(x: torch.Tensor, kv: int) -> torch.Tensor:
    """(B, T, H, hd) -> (B, T, KV, hd): each kv head's sum over its query
    group, in head order (the transpose of ``repeat_kv``)."""
    b, t, h, hd = x.shape
    return x.reshape(b, t, kv, h // kv, hd).sum(3)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                            causal: bool = True):
    """``(dq, dk, dv)`` of ``flash_attention_ref`` for the output gradient
    ``do``, by the explicit formulas, in f32 and returned in the inputs'
    type: ``P = exp(S - lse)`` (0 where masked), ``delta = rowsum(dO o O)``,
    ``dV = P^T dO``, ``dS = P o (dO V^T - delta)``, ``dQ = dS K scale`` and
    ``dK = dS^T Q scale``; each kv head's dk and dv summed over its query
    group. ``o`` is the forward's output and ``lse`` its row logsumexp
    (``flash_attention_lse_ref``)."""
    return _flash_bwd(q, k, v, o, do, lse, causal)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _flash_bwd(q, k, v, o, do, lse, causal, operand=lambda x: x, score=lambda x: x):
    """``flash_attention_bwd_ref``'s formulas, with ``operand`` applied to P
    as dV's factor and to dS as dq's and dk's, and ``score`` to the scaled
    scores before the exp."""
    h, kv, hd = q.shape[2], k.shape[2], q.shape[-1]
    scale = hd ** -0.5
    kr, vr = repeat_kv(k, h).to(torch.float32), repeat_kv(v, h).to(torch.float32)
    qf, of, dof = (x.to(torch.float32) for x in (q, o, do))
    s, keep = _flash_scores(qf, kr, causal)
    p = torch.exp(score(s) - lse[..., None])
    if keep is not None:
        p = torch.where(keep, p, p.new_zeros(()))
    delta = (dof * of).sum(-1).transpose(1, 2)  # (B, H, Tq)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = operand(p * (dp - delta[..., None]))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", operand(p), dof)
    return dq.to(q.dtype), _group_sum(dk, kv).to(k.dtype), _group_sum(dv, kv).to(v.dtype)


def flash_attention_bwd_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                             causal: bool = True, round_scores: bool = False):
    """``(dq, dk, dv)``: ``flash_attention_bwd_ref`` as the CUDA ``wgmma``
    backward rounds it. A model of the kernel's arithmetic for the CPU, not
    a kernel: S, dP and every sum in f32; P rounded to bf16 only as dV's
    factor (``dV = bf16(P)^T dO``), dS = P (dP - delta) from the unrounded
    P and rounded to bf16 only as dq's and dk's factor. ``round_scores``
    is the form the kernel rejects: the scaled scores rounded to bf16
    before the exp as well, which moves P by up to ``2**-8 |S|`` relative,
    more than bf16's ``2**-8`` once ``|S| > 1``."""
    return _flash_bwd(q, k, v, o, do, lse, causal, operand=_bf16,
                      score=_bf16 if round_scores else (lambda x: x))


def flash_attention_bwd_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                             causal: bool = True, passes: int = 3, ties: str = "even",
                             chains: str = "short"):
    """``(dq, dk, dv)``: ``flash_attention_bwd_ref`` as the CUDA ``tf32x3``
    backward computes them, from the forward's ``o`` and ``lse``. A model of
    the kernels' arithmetic for the CPU, not a kernel:

    - ``delta = do . o`` in f32: each of a warp's 32 lanes sums its columns
      ``c = lane (mod 32)`` by fma in order, then a shuffle tree adds the
      lanes 16, 8, 4, 2 and 1 apart;
    - every product is a chain of m16n8k8 MMAs (``_mma``: products exact,
      the sum truncated to f32 at each MMA), each operand split into TF32
      hi and lo with ``ties``, in ``passes`` (``_mma_tf32``): S = q k^T and
      dP = do v^T over 8 columns of hd at a time (``_tf32_scores``); dq =
      dS k over 8 keys at a time, dv = P^T do and dk = dS^T q over 8
      queries at a time, in steps of 32, a kv head's group of query heads
      in head order;
    - ``P = exp(scale S - lse)`` and ``dS = P (dP - delta)`` in f32, 0 where
      masked; dq and dk are multiplied by scale at the end;
    - ``chains="short"`` (the kernels): S's and dP's small products in a
      chain of their own, and each step's product summed from zero (12 MMAs)
      and added to its gradient by one f32 add; ``chains="long"`` (the
      one-chain form): one chain an S and dP entry, and each gradient's
      running sum carrying every MMA of every step.

    The steps a kernel skips (causal) add exact zeros here."""
    if chains not in ("short", "long"):
        raise ValueError(f"chains is 'short' or 'long', got {chains!r}")
    h, kv, tq, tk, hd = q.shape[2], k.shape[2], q.shape[1], k.shape[1], q.shape[-1]
    group, scale = h // kv, hd ** -0.5
    qt, ot, dot = (x.to(torch.float32).transpose(1, 2) for x in (q, o, do))  # (B, H, Tq, hd)
    kt, vt = (repeat_kv(x, h).to(torch.float32).transpose(1, 2) for x in (k, v))

    lanes = dot.new_zeros((*dot.shape[:3], 32))
    for c0 in range(0, hd, 32):
        n = min(32, hd - c0)
        lanes[..., :n] = _fma(dot[..., c0:c0 + n], ot[..., c0:c0 + n], lanes[..., :n])
    for apart in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32, device=q.device) ^ apart]
    delta = lanes[..., 0]

    s = _tf32_scores(qt, kt, passes, ties, chains)
    dp = _tf32_scores(dot, vt, passes, ties, chains)
    keep = _causal_mask_rect(tq, tk, q.device) if causal else torch.ones(
        (tq, tk), dtype=torch.bool, device=q.device)
    p = torch.where(keep, torch.exp(s * scale - lse[..., None]), s.new_zeros(()))
    ds = p * (dp - delta[..., None])

    def chained(pairs):
        """The sum of a @ b over the pairs in order, each (B, X, M, n) @
        (B, X, n, hd) over n in steps of 32, 8 at a time."""
        acc = None
        for a, b in pairs:
            acc = a.new_zeros((*a.shape[:3], b.shape[-1])) if acc is None else acc
            for i0 in range(0, a.shape[-1], 32):
                part = acc.new_zeros(acc.shape) if chains == "short" else acc
                for c in range(i0, min(i0 + 32, a.shape[-1]), 8):
                    part, _ = _mma_tf32(part, None, "bxmn,bxnd->bxmd", a[..., c:c + 8],
                                        b[..., c:c + 8, :], passes, ties)
                acc = acc + part if chains == "short" else part
        return acc

    def by_group(x):  # (B, H, ...) -> the group's heads in order, each (B, KV, ...)
        return [x.reshape(x.shape[0], kv, group, *x.shape[2:])[:, :, j] for j in range(group)]

    dq = chained([(ds, kt)]) * scale
    dk = chained(zip(by_group(ds.transpose(-1, -2)), by_group(qt))) * scale
    dv = chained(zip(by_group(p.transpose(-1, -2)), by_group(dot)))
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def flash_attention_bwd_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                              plain, causal: bool = True, products: str = "f32"):
    """How far the backward kernel's ``(dq, dk, dv)`` may lie from ``plain``
    (``flash_attention_bwd_ref`` on the same inputs), per element, in f32:
    ``1e-5 M + 1e-7`` with ``M`` each gradient's sum of magnitudes, the same
    terms added in another order, plus one ulp of ``plain`` in its type for
    bf16 inputs (both round an f32 sum to bf16). ``M`` carries every
    term's own rounding: ``|dS| <= P (|dO| . |v| + |dO| . |O|) = dS_mag``,
    and P's relative error from the rounding of its exponent's argument,
    ``1 + scale |q| . |k| + |lse|`` eps. ``M_dv = P^T |dO|``, ``M_dq =
    scale dS_mag |K|``, ``M_dk = scale dS_mag^T |Q|``, group-summed as the
    gradients are.

    ``products="bf16"`` (the wgmma backward, ``flash_attention_bwd_bf16``)
    adds ``2**-8`` of the same sums over the terms' own magnitudes (P and
    dS_mag without the argument's factor): rounding P to bf16 before dV,
    and dS before dq and dk, moves each term by at most ``2**-8`` of its
    magnitude (8 significant bits, to nearest). Derived, not fitted; the
    f32 form is unchanged."""
    if products not in ("f32", "bf16"):
        raise ValueError(f"products is 'f32' or 'bf16', got {products!r}")
    h, kv, hd = q.shape[2], k.shape[2], q.shape[-1]
    scale = hd ** -0.5
    kr, vr = repeat_kv(k, h).to(torch.float32), repeat_kv(v, h).to(torch.float32)
    qf, of, dof = (x.to(torch.float32) for x in (q, o, do))
    s, keep = _flash_scores(qf, kr, causal)
    p = torch.exp(s - lse[..., None])
    dpa = torch.einsum("bqhd,bkhd->bhqk", dof.abs(), vr.abs())
    da = (dof.abs() * of.abs()).sum(-1).transpose(1, 2)[..., None]
    arg = 1 + torch.einsum("bqhd,bkhd->bhqk", qf.abs(), kr.abs()) * scale \
        + lse.abs()[..., None]
    ds_own = p * (dpa + da)
    ds_mag = ds_own * arg
    if keep is not None:
        p = torch.where(keep, p, p.new_zeros(()))
        ds_own = torch.where(keep, ds_own, ds_own.new_zeros(()))
        ds_mag = torch.where(keep, ds_mag, ds_mag.new_zeros(()))

    def sums(ds_m, p_m):  # (dq, dk, dv) sums of magnitudes, group-summed
        return (torch.einsum("bhqk,bkhd->bqhd", ds_m, kr.abs()) * scale,
                _group_sum(torch.einsum("bhqk,bqhd->bkhd", ds_m, qf.abs()) * scale, kv),
                _group_sum(torch.einsum("bhqk,bqhd->bkhd", p_m, dof.abs()), kv))

    mags = sums(ds_mag, p * arg)
    own = sums(ds_own, p) if products == "bf16" else (None,) * 3
    bounds = []
    for mag, term, want in zip(mags, own, plain):
        bound = 1e-5 * mag + 1e-7
        if term is not None:
            bound = bound + 2.0 ** -8 * term
        if want.dtype != torch.float32:
            _, exp = torch.frexp(want.to(torch.float32))
            bound = bound + torch.ldexp(torch.ones_like(mag), exp - 8)
        bounds.append(bound)
    return tuple(bounds)


def flash_attention_lse_bound(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                              causal: bool = True) -> torch.Tensor:
    """How far the forward kernel's lse may lie from ``lse``
    (``flash_attention_lse_ref``), per row: ``1e-5 (|lse| + max_j scale
    |q_i| . |k_j| + 1)``, the scores' own rounding and the running sum's
    taken in another order."""
    s, keep = _flash_scores(q.abs(), repeat_kv(k, q.shape[2]).abs(), causal)
    if keep is not None:
        s = torch.where(keep, s, s.new_zeros(()))
    return 1e-5 * (lse.abs() + s.amax(-1) + 1)
