"""The wgmma ``flash_attention`` backward's rounding on the CPU.

- a CPU model of the CUDA ``wgmma`` backward
  (``ref.flash_attention_bwd_bf16``: S, dP and every sum in f32, P rounded
  to bf16 only as dV's factor and dS only as dq's and dk's) holds
  ``ref.flash_attention_bwd_bound(..., products="bf16")`` against the
  plain backward and against ``jax.vjp`` of JAX's ``chunked_attention``
  (in f32 on the same bf16 values), at hd 64, 80, 128 and 160 with H/KV
  1, 4, 2 and 4, causal and full, and on values of one sign (q and k times
  1, 2 and 3); the kernel's query step at hd 160 (32 rows in its dk/dv
  kernel, 64 below) changes no sum's order the model takes, so one model
  serves every head dim;
- the rejected form, the scores rounded to bf16 before the exp, misses
  that bound on values of one sign;
- the bf16 term is what admits the model: the model misses the f32 bound,
  whose form ``products="f32"`` keeps to the bit.

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

from repro.models import layers as jlayers
from repro_torch.kernels import ref


@pytest.fixture(autouse=True)
def _one_thread():
    """The models run small tensor ops; with the suite's workers sharing
    the cores, intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = {"hd 64, H/KV 1": (64, 4), "hd 80, H/KV 4": (80, 1), "hd 128, H/KV 2": (128, 2),
         "hd 160, H/KV 4": (160, 1)}


@functools.lru_cache(maxsize=None)
def _case(name, mul=0):
    """bf16 q, k, v and an output gradient (numpy from a seed), B 2, T 64,
    4 query heads. ``mul`` > 0: q and k of one sign (|N(0, 1)| times
    ``mul``), the case where the scores are large and alike."""
    hd, kv = CASES[name]
    rng = np.random.default_rng(hd + kv + 10 * mul)

    def draw(heads, scaled):
        x = rng.normal(size=(2, 64, heads, hd))
        return np.abs(x) * mul if scaled and mul else x

    q, k, v, do = draw(4, True), draw(kv, True), draw(kv, False), draw(4, False)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
                 for x in (q, k, v, do))


def _forward(q, k, v, causal):
    return ref.flash_attention_ref(q, k, v, causal), ref.flash_attention_lse_ref(q, k, causal)


def _within(got, want, bounds):
    return [bool(((g.float() - w.float()).abs() <= bd).all())
            for g, w, bd in zip(got, want, bounds)]


@functools.lru_cache(maxsize=None)
def _jax_grads(name, causal):
    """dq, dk, dv of the case by ``jax.vjp`` of JAX's ``chunked_attention``
    in f32 on the bf16 values (kv heads repeated into their groups), in
    chunks of 32 positions."""
    q, k, v, do = (x.to(torch.float32).numpy() for x in _case(name))
    h = q.shape[2]

    def chunked(a, b, c):
        return jlayers.chunked_attention(a, jnp.repeat(b, h // b.shape[2], axis=2),
                                         jnp.repeat(c, h // c.shape[2], axis=2),
                                         causal=causal, q_chunk=32, kv_chunk=32)

    grads = jax.jit(lambda a, b, c, g: jax.vjp(chunked, a, b, c)[1](g))
    return tuple(torch.from_numpy(np.array(x)) for x in grads(q, k, v, do))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_bf16_backward_model_holds_the_bf16_bound(name, causal):
    """P and dS rounded to bf16 as product operands keep dq, dk and dv within
    the bf16 bound (the f32 bound plus 2**-8 of each gradient's sum of its
    terms' magnitudes) of the plain backward and of JAX's autodiff."""
    q, k, v, do = _case(name)
    o, lse = _forward(q, k, v, causal)
    got = ref.flash_attention_bwd_bf16(q, k, v, o, do, lse, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, causal, products="bf16")
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.bfloat16
    assert _within(got, want, bounds) == [True] * 3
    assert _within(got, _jax_grads(name, causal), bounds) == [True] * 3


@pytest.mark.parametrize("mul", [1, 2, 3])
def test_bf16_backward_model_holds_the_bound_on_same_sign_values(mul):
    """q and k of one sign, times 1, 2 and 3: scores of 5 to 50 that differ
    little from key to key; the kernel's rounding stays within the bound."""
    q, k, v, do = _case("hd 80, H/KV 4", mul)
    o, lse = _forward(q, k, v, True)
    got = ref.flash_attention_bwd_bf16(q, k, v, o, do, lse, True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, True, products="bf16")
    assert _within(got, want, bounds) == [True] * 3


@pytest.mark.parametrize("mul", [1, 2, 3])
def test_scores_rounded_before_the_exp_miss_the_bound(mul):
    """The rejected form: S rounded to bf16 before the exp moves P by up to
    2**-8 |S| relative, more than the bound allows once the scores are
    large; on values of one sign some gradient misses it."""
    q, k, v, do = _case("hd 80, H/KV 4", mul)
    o, lse = _forward(q, k, v, True)
    got = ref.flash_attention_bwd_bf16(q, k, v, o, do, lse, True, round_scores=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, True, products="bf16")
    assert not all(_within(got, want, bounds))


def test_bf16_rounding_needs_the_bf16_term():
    """The f32 bound (1e-5 of the magnitudes) does not admit the bf16
    operands: the model misses it on random values."""
    q, k, v, do = _case("hd 80, H/KV 4")
    o, lse = _forward(q, k, v, True)
    got = ref.flash_attention_bwd_bf16(q, k, v, o, do, lse, True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    bounds = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, True)
    assert not all(_within(got, want, bounds))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_bound_is_unchanged(dtype):
    """``products="f32"`` is the default and gives its bits; the bf16 form
    only adds to it; any other value raises."""
    q, k, v, do = (x.to(dtype) for x in _case("hd 64, H/KV 1"))
    o, lse = _forward(q, k, v, True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    default = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, True)
    f32 = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, True, products="f32")
    bf16 = ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, True, products="bf16")
    for a, b, c in zip(default, f32, bf16):
        assert torch.equal(a, b)
        assert bool((c >= a).all()) and bool((c > a).any())
    with pytest.raises(ValueError, match="products"):
        ref.flash_attention_bwd_bound(q, k, v, o, do, lse, want, True, products="tf32")
