"""Mamba2 mixer (``repro.models.mamba``): the SSD (state-space duality)
block in its chunked matmul form, the mixer around it, its decode step and
its cache. Used by ``mamba2-370m`` and as the "mamba" mixer of Jamba's 1:7
hybrid pattern.

Plain functions on tensors, as JAX's are: JAX's Mamba reaches no Pallas
kernel (einsums, a ``lax.scan`` over chunks and a shifted-sum depthwise
convolution), so none runs here. The projections are separate matrices
(``wz``, ``wx``, ``wb``, ``wc``, ``wdt``) in (in, out) layout, as in JAX.

Where the port departs from JAX's text, it computes the same numbers:
- the intra-chunk decay ``exp(a_i - a_j)`` is taken as ``exp(where(mask,
  seg, -inf))``. Its values are those of JAX's ``where(mask, exp(seg), 0)``
  bit for bit, but its gradient is finite: JAX's form overflows ``exp`` to
  inf above the diagonal at the published chunk of 256, and the backward
  pass then multiplies that inf by the mask's zero (NaN);
- B and C reach the heads of their group by a broadcast view, not a copy;
- the carry over chunks is a Python loop in scan order.
Everything from the SSD's inputs on is f32, as in JAX.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import MambaConfig
from ..utils import cdiv
from .layers import _normal


class MambaDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    headdim: int
    n_groups: int
    d_state: int
    d_conv: int


def mamba_dims(d_model: int, cfg: MambaConfig) -> MambaDims:
    d_inner = cfg.expand * d_model
    assert d_inner % cfg.headdim == 0
    return MambaDims(d_model, d_inner, d_inner // cfg.headdim, cfg.headdim, cfg.n_groups,
                     cfg.d_state, cfg.d_conv)


def init_mamba(d_model: int, cfg: MambaConfig, *, dtype=torch.float32, device=None,
               generator=None, lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """JAX's shapes, scales and dtypes, each leaf behind ``lead`` stacking
    axes: the projections and the conv weight normal in ``dtype`` (the
    projections at 1/sqrt(d_model), ``wo`` at 1/sqrt(d_inner), the conv at
    0.1), ``conv_b`` zeros in ``dtype``; ``A_log = log(1..H)``, ``D`` ones,
    ``norm_scale`` ones and ``dt_bias`` the inverse softplus of a dt drawn
    log-uniform in [dt_min, dt_max], all four f32 whatever ``dtype``."""
    dims = mamba_dims(d_model, cfg)
    gn = dims.n_groups * dims.d_state
    conv_dim = dims.d_inner + 2 * gn
    s = 1.0 / d_model ** 0.5
    kw = dict(dtype=dtype, device=device, generator=generator)

    def f32(t):
        return t.expand(*lead, -1).contiguous() if lead else t

    p = {"wz": _normal((*lead, d_model, dims.d_inner), s, **kw),
         "wx": _normal((*lead, d_model, dims.d_inner), s, **kw),
         "wb": _normal((*lead, d_model, gn), s, **kw),
         "wc": _normal((*lead, d_model, gn), s, **kw),
         "wdt": _normal((*lead, d_model, dims.n_heads), s, **kw),
         "conv_w": _normal((*lead, cfg.d_conv, conv_dim), 0.1, **kw)}
    u = torch.empty((*lead, dims.n_heads), dtype=torch.float32, device=device)
    u.uniform_(generator=generator)
    lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
    dt = torch.exp(u * (hi - lo) + lo)
    heads = torch.arange(1, dims.n_heads + 1, dtype=torch.float32, device=device)
    p.update({
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=device),
        "A_log": f32(torch.log(heads)),
        "D": f32(torch.ones((dims.n_heads,), dtype=torch.float32, device=device)),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # inverse softplus
        "norm_scale": f32(torch.ones((dims.d_inner,), dtype=torch.float32, device=device)),
        "wo": _normal((*lead, dims.d_inner, d_model), 1.0 / dims.d_inner ** 0.5, **kw),
    })
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time: x (B, L, C), w (K, C), b (C,).
    JAX's shifted sum: the K products added in the order i = 0..K-1, then
    ``+ b`` (``conv1d`` rounds elsewhere in bf16). Returns ``(y,
    new_state)``: the state, the last K-1 rows of the padded input (in x's
    dtype; a given state is concatenated in x's dtype), carries a decode on."""
    k, length = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + length] * w[i] for i in range(k)) + b
    new_state = xp[:, xp.shape[1] - (k - 1):].clone() if k > 1 else x[:, :0].clone()
    return y, new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan: x (B, L, H, P), dt (B, L, H) after softplus,
    A (H,) negative, Bm and Cm (B, L, G, N), the state entering (B, H, P,
    N) or zeros. Returns ``(y (B, L, H, P), final_state (B, H, P, N))``,
    both f32. L is padded to a multiple of the chunk (a zero dt leaves the
    state as it is); within a chunk the quadratic (attention-like) term,
    across chunks the state recurrence."""
    f32 = torch.float32
    b, length, h, pd = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    q = min(chunk, length)
    nc = cdiv(length, q)
    pad = nc * q - length
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))

    def chunked(t):  # (B, NC*Q, ...) -> (NC, B, Q, ...)
        return t.reshape(b, nc, q, *t.shape[2:]).transpose(0, 1)

    xc, dtc, Bc, Cc = chunked(x), chunked(dt), chunked(Bm).to(f32), chunked(Cm).to(f32)
    a_cum = torch.cumsum(dtc.to(f32) * A, dim=2)  # (NC, B, Q, H), within the chunk
    a_tot = a_cum[:, :, -1]  # (NC, B, H)
    xdt = xc.to(f32) * dtc[..., None].to(f32)  # (NC, B, Q, H, P)
    Bg, Cg = Bc.transpose(2, 3), Cc.transpose(2, 3)  # (NC, B, G, Q, N)

    # -- intra-chunk: y_i = sum_{j <= i} C_i.B_j exp(a_i - a_j) x_j dt_j ----
    cb = Cg @ Bg.transpose(-1, -2)  # (NC, B, G, Q, Q), a group's heads share it
    ai = a_cum.transpose(2, 3)  # (NC, B, H, Q)
    seg = ai[..., :, None] - ai[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    Lmat = torch.exp(torch.where(mask, seg, seg.new_full((), -math.inf)))
    scores = Lmat.reshape(nc, b, g, hg, q, q) * cb[:, :, :, None]
    xk = xdt.permute(0, 1, 3, 2, 4).reshape(nc, b, g, hg, q, pd)  # (.., G, hg, K, P)
    y_intra = (scores @ xk).reshape(nc, b, h, q, pd).transpose(2, 3)  # (NC, B, Q, H, P)
    del seg, Lmat, scores  # the largest tensors here: freed at once outside autograd

    # -- chunk states: S_c = sum_j exp(a_tot - a_j) B_j (x_j dt_j) --------
    decay_to_end = torch.exp(a_tot[:, :, None] - a_cum)  # (NC, B, Q, H)
    w = (xdt * decay_to_end[..., None]).permute(0, 1, 3, 4, 2)  # (NC, B, H, P, Q)
    S = (w.reshape(nc, b, g, hg * pd, q) @ Bg).reshape(nc, b, h, pd, n)

    # -- the carry across chunks, in scan order: the state entering each ---
    carry = (torch.zeros((b, h, pd, n), dtype=f32, device=x.device) if init_state is None
             else init_state.to(f32))
    h_prev = []
    for c in range(nc):
        h_prev.append(carry)
        carry = carry * torch.exp(a_tot[c])[:, :, None, None] + S[c]
    h_prev = torch.stack(h_prev)  # (NC, B, H, P, N)

    # -- y_inter_i = C_i . (exp(a_i) h_prev) --------------------------------
    hp = h_prev.reshape(nc, b, g, hg * pd, n).transpose(-1, -2)  # (.., G, N, hg*P)
    y_inter = (Cg @ hp).reshape(nc, b, g, q, hg, pd).permute(0, 1, 3, 2, 4, 5)
    y_inter = y_inter.reshape(nc, b, q, h, pd) * torch.exp(a_cum)[..., None]

    y = (y_intra + y_inter).transpose(0, 1).reshape(b, nc * q, h, pd)
    return (y[:, :length] if pad else y), carry


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, init_state: Optional[torch.Tensor] = None, *,
                  dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(L) recurrence, one step a position (JAX's ``ssd_reference``),
    in ``dtype`` (f32 as in JAX; f64 for a check of the chunked form)."""
    b, length, h, pd = x.shape
    hg = h // Bm.shape[2]
    state = (torch.zeros((b, h, pd, Bm.shape[3]), dtype=dtype, device=x.device)
             if init_state is None else init_state.to(dtype))
    A = A.to(dtype)
    ys = []
    for t in range(length):
        a_t = torch.exp(dt[:, t].to(dtype) * A)  # (B, H)
        Bt = Bm[:, t].to(dtype).repeat_interleave(hg, dim=1)  # (B, H, N)
        Ct = Cm[:, t].to(dtype).repeat_interleave(hg, dim=1)
        xt = x[:, t].to(dtype) * dt[:, t, :, None].to(dtype)  # (B, H, P)
        state = state * a_t[:, :, None, None] + xt[..., None] * Bt[:, :, None, :]
        ys.append((state @ Ct[..., None])[..., 0])
    return torch.stack(ys, dim=1), state


def mamba_mixer(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MambaConfig, *,
                conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None):
    """The Mamba2 mixer on x (B, L, D): the projections, the causal conv and
    SiLU, the split into x, B and C, dt by softplus (JAX's ``logaddexp(.,
    0)``), the SSD, the ``D`` skip, the gated RMSNorm (eps 1e-5) and ``wo``.
    Returns ``(out, (conv_state, ssm_state))``, the states a decode carries
    on (the conv's in x's dtype, the SSD's in f32)."""
    f32 = torch.float32
    dims = mamba_dims(x.shape[-1], cfg)
    b, length, _ = x.shape
    gn = dims.n_groups * dims.d_state
    z = x @ params["wz"]
    xbc = torch.cat([x @ params["wx"], x @ params["wb"], x @ params["wc"]], dim=-1)
    dt_raw = x @ params["wdt"]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xr, br, cr = xbc.split([dims.d_inner, gn, gn], dim=-1)

    dt_in = dt_raw.to(f32) + params["dt_bias"]
    dt = torch.logaddexp(dt_in, dt_in.new_zeros(()))
    A = -torch.exp(params["A_log"])
    xh = xr.reshape(b, length, dims.n_heads, dims.headdim)
    Bm = br.reshape(b, length, dims.n_groups, dims.d_state)
    Cm = cr.reshape(b, length, dims.n_groups, dims.d_state)
    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.chunk_size, ssm_state)
    y = y + params["D"][:, None] * xh.to(f32)
    y = y.reshape(b, length, dims.d_inner)
    y = y * F.silu(z.to(f32))  # the gate, then RMSNorm
    ms = y.square().mean(-1, keepdim=True)
    y = y * torch.rsqrt(ms + 1e-5) * params["norm_scale"]
    return y.to(x.dtype) @ params["wo"], (new_conv, final_state)


def mamba_decode_step(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MambaConfig,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token, x (B, 1, D): the mixer at L = 1 from both states. Returns
    ``(out, conv_state, ssm_state)``, the states carried on, as new
    tensors: the ones passed in are not written."""
    out, (conv, ssm) = mamba_mixer(params, x, cfg, conv_state=conv_state,
                                   ssm_state=ssm_state)
    return out, conv, ssm


def init_mamba_cache(batch: int, d_model: int, cfg: MambaConfig,
                     dtype: torch.dtype = torch.float32, *, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero states: conv (B, K-1, d_inner + 2 G N) in ``dtype``, ssm (B, H,
    P, N) in f32."""
    dims = mamba_dims(d_model, cfg)
    conv_dim = dims.d_inner + 2 * dims.n_groups * dims.d_state
    conv = torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=device)
    ssm = torch.zeros((batch, dims.n_heads, dims.headdim, dims.d_state), dtype=torch.float32,
                      device=device)
    return conv, ssm
