"""The tf32x3 ``flash_attention`` backward's arithmetic on the CPU, and the
choice of backward kernel.

- a CPU model of the CUDA ``tf32x3`` backward
  (``ref.flash_attention_bwd_tf32``: every product a chain of TF32 MMAs in
  split precision that truncates as the tensor cores add, either tie rule)
  holds ``ref.flash_attention_bwd_bound`` against the plain backward and
  against ``jax.vjp`` of JAX's ``chunked_attention`` (the function FuXi's
  JAX layers differentiate), at hd 64 with H/KV 1 and 4 and on the port's
  ``fuxi-reduced`` layer 0 inputs, causal and full; one TF32 pass misses
  the bound;
- on values of one sign the kernels' short MMA chains hold the bound where
  the one-chain form misses it;
- ``flash_attention.bwd_variant`` is a function of type and head dim alone
  (tf32x3, wgmma or the general kernel), checked on CPU tensors.

The kernel itself is held against the plain backward on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_fuxi_inputs import fuxi_layer0_qkv
from repro.models import layers as jlayers
from repro_torch.kernels import ref
from repro_torch.kernels import flash_attention as fa


@pytest.fixture(autouse=True)
def _one_thread():
    """The CPU models run many small tensor ops. With the suite's workers
    sharing the cores, intra-op threads only contend (the same-sign case
    took 200 s of what one thread does in 3 s), so each test here runs on
    one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(name):
    """q, k, v and an output gradient (numpy from a seed)."""
    rng = np.random.default_rng(17)
    if name == "fuxi-reduced layer 0":
        q, k, v = fuxi_layer0_qkv()
    else:
        kv = {"hd 64, H/KV 1": 4, "hd 64, H/KV 4": 1}[name]
        q, k, v = (torch.from_numpy(rng.normal(size=(2, 64, n, 64)).astype(np.float32))
                   for n in (4, kv, kv))
    return q, k, v, torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))


def _forward(q, k, v, causal):
    """The plain forward's output and row logsumexp, which the backward
    reads."""
    return ref.flash_attention_ref(q, k, v, causal), ref.flash_attention_lse_ref(q, k, causal)


def _within(got, want, bounds):
    return [bool(((g - w).abs() <= bd).all()) for g, w, bd in zip(got, want, bounds)]


CASES = ["hd 64, H/KV 1", "hd 64, H/KV 4", "fuxi-reduced layer 0"]


@functools.lru_cache(maxsize=None)
def _jax_grads(case, causal):
    """dq, dk, dv of the case by ``jax.vjp`` of JAX's ``chunked_attention``
    (kv heads repeated into their groups, as FuXi's JAX layer does), in
    chunks of 32 positions."""
    q, k, v, do = _case(case)
    h = q.shape[2]

    def chunked(a, b, c):
        return jlayers.chunked_attention(a, jnp.repeat(b, h // b.shape[2], axis=2),
                                         jnp.repeat(c, h // c.shape[2], axis=2),
                                         causal=causal, q_chunk=32, kv_chunk=32)

    grads = jax.jit(lambda a, b, c, g: jax.vjp(chunked, a, b, c)[1](g))
    return tuple(torch.from_numpy(np.array(x))
                 for x in grads(*(jnp.asarray(x.numpy()) for x in (q, k, v, do))))


@pytest.mark.parametrize("ties", ["even", "away"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_tf32x3_flash_backward_holds_the_kernel_limit(case, causal, ties):
    """The ``tf32x3`` backward's products in split precision (as the CUDA
    kernels take them, split with either tie rule, truncating at each MMA)
    keep dq, dk and dv within ``ref.flash_attention_bwd_bound`` (1e-5 of
    each gradient's sum of magnitudes + 1e-7) of the plain backward and of
    ``jax.vjp`` of JAX's ``chunked_attention``."""
    q, k, v, do = _case(case)
    o, lse = _forward(q, k, v, causal)
    got = ref.flash_attention_bwd_tf32(q, k, v, o, do, lse, causal, passes=3, ties=ties)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
    assert _within(got, want, bounds) == [True] * 3
    assert _within(got, _jax_grads(case, causal), bounds) == [True] * 3


@pytest.mark.parametrize("ties", ["even", "away"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_one_pass_tf32_flash_backward_misses_the_kernel_limit(case, causal, ties):
    """One TF32 pass (10 mantissa bits) misses ``ref.flash_attention_bwd_bound``
    on some gradient: the reason the kernels take three."""
    q, k, v, do = _case(case)
    o, lse = _forward(q, k, v, causal)
    got = ref.flash_attention_bwd_tf32(q, k, v, o, do, lse, causal, passes=1, ties=ties)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, causal)
    assert not all(_within(got, want, bounds))


def _same_sign_case(t=512, hd=16, h=4, seed=21):
    """Every query head of one kv group (H/KV 4) at FuXi's T and
    ``fuxi-reduced``'s hd puts all its weight on key 0 (score 0 there, -20 at every other key: lse ~ 0,
    so the bound's rounding term for P is small), and do is shifted by 2:
    dv_0 = sum_i P_i0 do_i, over 4 x 512 queries, is one long sum whose
    terms share a sign."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=hd).astype(np.float32)
    q = np.broadcast_to(u, (1, t, h, hd))
    k = np.broadcast_to(-20 * hd ** 0.5 / float(u @ u) * u, (1, t, 1, hd)).copy()
    k[:, 0] = 0
    v = rng.normal(size=(1, t, 1, hd))
    do = rng.normal(size=(1, t, h, hd)) + 2
    return [torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)) for x in (q, k, v, do)]


@pytest.mark.parametrize("ties", ["even", "away"])
def test_short_backward_chains_hold_the_limit_where_long_ones_miss_it(ties):
    """The tensor cores add truncating, so a sum that runs through one MMA
    chain drifts toward zero. On values of one sign the kernels' short
    chains (S's and dP's small products apart, each 32-row step's product
    from zero) hold ``ref.flash_attention_bwd_bound``; the one-chain form
    (every gradient's running sum through every MMA of every step and of
    the group's heads) misses it on dv. The model truncates at most one ulp
    an MMA, less than the tensor cores lose, so the case takes the
    smallest group at FuXi's T at which the drift shows here: 4 heads over
    one kv head."""
    q, k, v, do = _same_sign_case()
    o, lse = _forward(q, k, v, True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, True)
    short = ref.flash_attention_bwd_tf32(q, k, v, o, do, lse, True, ties=ties)
    assert _within(short, want, bounds) == [True] * 3
    long = ref.flash_attention_bwd_tf32(q, k, v, o, do, lse, True, ties=ties, chains="long")
    assert _within(long, want, bounds) == [True, True, False]


def _view(shape, dtype, offset=0, pad=0):
    """A (B, T, heads, hd) view ``offset`` elements into rows padded by
    ``pad`` elements past hd, like a column slice of a fused projection."""
    b, t, h, hd = shape
    wide = torch.zeros((b, t, h, hd + offset + pad), dtype=dtype)
    return wide[..., offset:offset + hd]


@pytest.mark.parametrize("q,k,want", [
    (_view((64, 512, 8, 64), torch.float32), _view((64, 512, 8, 64), torch.float32),
     "tf32x3"),                                           # FuXi's main-path call
    *[(_view((2, 9, 4, hd), torch.float32), _view((2, 9, 1, hd), torch.float32), want)
      for hd, want in ((1, "tf32x3"), (5, "tf32x3"), (16, "tf32x3"), (128, "tf32x3"),
                       (129, "simple"), (160, "simple"), (256, "simple"))],
    *[(_view((2, 9, 4, hd), torch.bfloat16), _view((2, 9, 1, hd), torch.bfloat16), want)
      for hd, want in ((16, "simple"), (64, "wgmma"), (80, "wgmma"), (128, "wgmma"),
                       (160, "wgmma"), (192, "simple"), (256, "simple"))],
    (_view((2, 9, 4, 64), torch.float32, 3, 5), _view((2, 9, 1, 64), torch.float32, 1),
     "tf32x3"),                                           # off 16-byte alignment
    (_view((2, 9, 4, 80), torch.bfloat16, 3, 5), _view((2, 9, 1, 80), torch.bfloat16, 1),
     "wgmma"),                                            # bf16 off alignment
    (_view((2, 9, 4, 64), torch.float32).transpose(1, 2).contiguous().transpose(1, 2),
     _view((2, 9, 1, 64), torch.float32), "tf32x3"),      # heads outside positions
])
def test_backward_kernel_choice(q, k, want):
    """The backward kernel is chosen by type and head dim alone, never by
    the layout: f32 at hd up to 128 goes to the tf32x3 kernel, bf16 at hd
    64, 80, 128 and 160 to the wgmma one, bf16 at other head dims and f32 above
    128 to the general one."""
    assert fa.bwd_variant(q, k, k) == want
    assert fa.bwd_variant(q.contiguous(), k.contiguous(), k.contiguous()) == want
