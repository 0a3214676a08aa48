"""The port's HSTU model and its attention's plain versions against JAX.

- the plain ``hstu_attention_ref`` (what a CPU tensor runs) against JAX's
  Pallas kernel in interpret mode and its jnp oracle, at the shapes of
  tests/test_kernels.py plus T in {1, 40}, causal and not, within
  ``atol=2e-5`` (that test's tolerance; XLA and torch add the products in
  another order);
- the plain backward ``hstu_attention_bwd_ref`` against ``jax.vjp`` of the
  oracle and against torch autograd of the plain forward, within 1e-5;
- the port's HSTU layer against JAX's ``_hstu_layer`` on the same weights
  (the layer-against-kernel check: the port's layer calls the attention
  op, JAX's computes it inline in query chunks), within 1e-5;
- ``hstu_forward``, ``sequence_infonce`` and the loss, with its dense and
  embedding gradients, against ``jax.value_and_grad`` at ``hstu-reduced``,
  within 1e-5; then with bf16 lookups, where the embedding gradient comes
  back in bf16 and may round to the neighbouring bf16 value;
- the conversion of JAX's stacked layer params into the port's state dict.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.configs.registry import get_arch as jget_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import hstu as jhstu
from repro_torch.configs.registry import get_arch
from repro_torch.convert import hstu_params_from_jax
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import hstu_attention as ha
from repro_torch.models import HSTU, hstu_forward, hstu_layer, make_hstu_loss_fn, \
    sequence_infonce

SHAPES = [(1, 64, 2, 32, 32), (2, 96, 4, 64, 64), (1, 200, 2, 48, 96),
          (2, 1, 2, 16, 8), (1, 40, 3, 16, 24)]


def _qkv(b, t, h, dqk, dv, seed=5, scale=0.3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, t, h, d)) * scale).astype(np.float32)
            for d in (dqk, dqk, dv)]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,h,dqk,dv", SHAPES)
def test_plain_attention_matches_jax_kernel_and_oracle(b, t, h, dqk, dv, causal):
    q, k, v = _qkv(b, t, h, dqk, dv)
    got = dispatch.hstu_attention(*_t(q, k, v), causal=causal)
    assert got.shape == (b, t, h, dv) and got.dtype == torch.float32
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kernel = jops.hstu_attention(jq, jk, jv, causal=causal, block_q=32,
                                 block_k=32, interpret=True)
    oracle = jref.hstu_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=0, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,h,dqk,dv", [(1, 64, 2, 32, 32), (1, 40, 3, 16, 24),
                                          (2, 33, 2, 48, 96)])
def test_plain_backward_matches_jax_vjp_and_autograd(b, t, h, dqk, dv, causal):
    q, k, v = _qkv(b, t, h, dqk, dv, seed=7, scale=0.5)
    do = np.random.default_rng(8).normal(size=(b, t, h, dv)).astype(np.float32)
    got = ref.hstu_attention_bwd_ref(*_t(q, k, v, do), causal=causal)
    _, vjp = jax.vjp(lambda a, b_, c: jref.hstu_attention_ref(a, b_, c, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref.hstu_attention_ref(*leaves, causal=causal).backward(torch.from_numpy(do))
    for g, w, leaf in zip(got, want, leaves):
        assert g.shape == leaf.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), rtol=0, atol=1e-5)


def test_cpu_attention_launches_nothing():
    q, k, v = _t(*_qkv(1, 8, 2, 4, 4))
    before = (ha.launches_fwd, ha.launches_bwd)
    q.requires_grad_()
    dispatch.hstu_attention(q, k, v).sum().backward()
    assert (ha.launches_fwd, ha.launches_bwd) == before
    with pytest.raises(ValueError, match="CUDA"):
        ha.hstu_attention_fwd(q.detach(), k, v)


def _jax_params(cfg, seed=0):
    params = jhstu.init_hstu_params(jax.random.PRNGKey(seed), cfg)
    # non-trivial norms, so a swapped scale or bias shows
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + rng.normal(size=x.shape).astype(np.float32)
                              * 0.1), params)


def _port_params(jparams):
    return hstu_params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("s", [32, 40])
def test_layer_matches_jax_layer_on_converted_weights(s):
    cfg = jget_arch("hstu-industrial").reduced  # d 64, 4 heads, dqk = dv = 16
    jparams = _jax_params(cfg)
    params = _port_params(jparams)
    x = np.random.default_rng(3).normal(size=(2, s, cfg.d_model)).astype(np.float32)
    h, d = cfg.n_heads, cfg.d_model // cfg.n_heads
    lp = jax.tree.map(lambda a: a[1], jparams["layers"])  # the second layer
    want = jhstu._hstu_layer(lp, jnp.asarray(x), h, d, d, cfg.norm_eps, q_chunk=16)
    got = hstu_layer(params, "layers.1", torch.from_numpy(x), h, d, d, cfg.norm_eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _emb(cfg, b, dtype=np.float32, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, cfg.seq_len, cfg.max_table_dim)) * 0.1).astype(dtype)


def test_forward_and_infonce_match_jax():
    jcfg = jget_arch("hstu-industrial").reduced
    cfg = get_arch("hstu-industrial").reduced
    jparams = _jax_params(jcfg, seed=2)
    params = _port_params(jparams)
    emb = _emb(cfg, 3)
    want = jhstu.hstu_forward(jparams, jcfg, jnp.asarray(emb))
    got = hstu_forward(params, cfg, torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    preds, targets = np.asarray(want)[:, :-1], np.asarray(want)[:, 1:] * 0.7 + 0.1
    jl, ja = jhstu.sequence_infonce(jnp.asarray(preds), jnp.asarray(targets))
    tl, ta = sequence_infonce(*_t(preds, targets))
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert float(ta) == float(ja)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax_value_and_grad(dtype):
    """Loss, metric, dense and embedding gradients at ``hstu-reduced``. With
    bf16 lookups the forward lifts them to f32 (JAX promotes ``bf16 @ f32``)
    and the embedding gradient comes back in bf16: an f32 gradient that
    differs in its last bits may round to the neighbouring bf16 value, so
    that one is held within one bf16 step (at most 2**-7 of the value, bf16
    keeping 8 significant bits) plus 1e-5."""
    jcfg = jget_arch("hstu-industrial").reduced
    cfg = get_arch("hstu-industrial").reduced
    jparams = _jax_params(jcfg, seed=3)
    params = {k: v.requires_grad_() for k, v in _port_params(jparams).items()}
    emb32 = _emb(cfg, 2, seed=9)
    jemb = jnp.asarray(emb32, dtype=jnp.dtype(dtype))
    emb = torch.from_numpy(emb32).to(getattr(torch, dtype)).requires_grad_()

    jloss_fn = jhstu.make_hstu_loss_fn(jcfg, None, None)
    (jl, jm), (jg, jge) = jax.value_and_grad(jloss_fn, argnums=(0, 1), has_aux=True)(
        jparams, jemb, {})
    loss, metrics = make_hstu_loss_fn(cfg)(params, emb, {})
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    assert float(metrics["hitrate_inseq"]) == float(jm["hitrate_inseq"])
    want = hstu_params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(want) == set(params)
    for k, w in want.items():
        np.testing.assert_allclose(params[k].grad.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert emb.grad.dtype == emb.dtype
    ge, wge = emb.grad.to(torch.float32).numpy(), np.asarray(jge, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(ge, wge, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(ge, wge, rtol=2.0 ** -7, atol=1e-5)
        assert np.mean(ge == wge) > 0.95


def test_stacked_params_convert_to_the_module_state_dict():
    jcfg = jget_arch("hstu-industrial").reduced
    cfg = get_arch("hstu-industrial").reduced
    jparams = _jax_params(jcfg, seed=6)
    params = _port_params(jparams)
    model = HSTU(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert list(params) == list(sd) or set(params) == set(sd)
    for k, v in sd.items():
        assert params[k].shape == v.shape and params[k].dtype == v.dtype, k
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(params[f"layers.{i}.w_uvqk"].numpy(),
                                      np.asarray(jparams["layers"]["w_uvqk"][i]))
        np.testing.assert_array_equal(params[f"layers.{i}.out_norm.bias"].numpy(),
                                      np.asarray(jparams["layers"]["out_norm"]["bias"][i]))
    np.testing.assert_array_equal(params["in_proj"].numpy(), np.asarray(jparams["in_proj"]))
    model.load_state_dict(params)  # loads with strict name and shape checks
    emb = torch.from_numpy(_emb(cfg, 1))
    torch.testing.assert_close(model(emb), hstu_forward(params, cfg, emb),
                               rtol=0, atol=0)
