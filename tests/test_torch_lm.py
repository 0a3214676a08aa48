"""The port's dense-LM serving path and its attention against JAX on the CPU.

- the plain ``flash_attention_ref`` (what a CPU tensor runs) against JAX's
  Pallas kernel in interpret mode and its jnp oracle, at the shapes of
  tests/test_kernels.py, causal and not: f32 within ``atol=2e-5`` (that
  test's tolerance; XLA and torch add in another order), bf16 inputs within
  ``atol=2e-2`` of the f32 oracle (as ``test_flash_attention_bf16``);
- k and v with fewer heads than q against JAX on ``_repeat_kv``'d inputs;
- the port's ``gqa_attention`` against JAX's for ``impl`` in {naive,
  chunked, pallas} (three ways to one function; the port has one);
- ``apply_rope``, ``apply_mlp`` (swiglu, relu2, gelu) and ``gqa_decode``
  (output and cache) within 1e-5;
- ``lm_prefill`` logits and caches, then 4 ``lm_decode_step``s, for the
  reduced stablelm-12b, stablelm-3b, yi-34b and nemotron-4-340b, f32,
  within 1e-5; and reduced stablelm-12b computing in bf16;
- ``Session.serve`` tokens equal JAX ``Session.serve``'s on the same
  weights (JAX's fresh init handed over through ``convert``);
- ``lm_params_from_jax`` names, shapes and dtypes; an LM session trains
  (tests/test_torch_lm_train.py holds its training against JAX) and
  refuses recsys serving; the LM serving CLI runs on the CPU.

Every input is drawn with numpy from a seed and handed to both packages.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.api import Session as JSession
from repro.configs.registry import get_arch as jget_arch
from repro.core.embedding.table import init_table_state as jinit_table
from repro.core.embedding.table import make_mega_table_spec as jmake_spec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.api import Session
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax, table_from_jax
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT

LM_ARCHS = ["stablelm-12b", "stablelm-3b", "yi-34b", "nemotron-4-340b"]
FLASH_SHAPES = [(1, 64, 2, 64), (2, 100, 4, 32), (1, 256, 1, 128)]


def _normal(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# flash_attention: the plain version against JAX's kernel and oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,h,hd", FLASH_SHAPES)
def test_plain_flash_attention_matches_jax_kernel_and_oracle(b, t, h, hd, causal):
    q, k, v = (_normal((b, t, h, hd), s) for s in (1, 2, 3))
    got = dispatch.flash_attention(*_t(q, k, v), causal=causal)
    assert got.shape == (b, t, h, hd) and got.dtype == torch.float32
    kernel = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, block_q=32, block_k=32, interpret=True)
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_attention_bf16(causal):
    q, k, v = (_normal((2, 64, 2, 64), s) for s in (4, 5, 6))
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = dispatch.flash_attention(qb, kb, vb, causal=causal)
    assert got.dtype == torch.bfloat16
    # the f32 oracle on the bf16 values, and JAX's kernel on the bf16 inputs
    lifted = [jnp.asarray(x.float().numpy()) for x in (qb, kb, vb)]
    oracle = jref.flash_attention_ref(*lifted, causal=causal)
    kernel = jops.flash_attention(*(x.astype(jnp.bfloat16) for x in lifted),
                                  causal=causal, block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(oracle), atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(kernel), atol=2e-2)


@pytest.mark.parametrize("tq,tk,h,kv,causal", [(40, 40, 8, 2, True), (33, 100, 4, 1, False),
                                               (100, 33, 6, 3, True), (1, 1, 4, 2, True)])
def test_plain_flash_attention_reads_kv_heads_in_groups(tq, tk, h, kv, causal):
    q = _normal((2, tq, h, 16), 7)
    k, v = _normal((2, tk, kv, 16), 8), _normal((2, tk, kv, 16), 9)
    got = dispatch.flash_attention(*_t(q, k, v), causal=causal)
    kk, vv = (JL._repeat_kv(jnp.asarray(x), h // kv) for x in (k, v))
    want = jref.flash_attention_ref(jnp.asarray(q), kk, vv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert torch.equal(L._repeat_kv(torch.from_numpy(k), h // kv),
                       torch.from_numpy(np.asarray(kk)))


def test_flash_attention_dispatch_refuses_mixed_devices():
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="no path"):
        dispatch.flash_attention(x, x.to("meta"), x)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _attn_params(cfg, d, seed):
    jp = JL.init_attention(jax.random.PRNGKey(seed), d, cfg)
    return jp, {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_gqa_attention_matches_jax_for_every_impl(impl):
    cfg = jget_arch("stablelm-12b").reduced  # d 64, 4 heads over 2 kv heads, hd 16
    a = dataclasses.replace(cfg.attention, impl=impl)
    jp, tp = _attn_params(a, cfg.d_model, 3)
    x = _normal((2, 40, cfg.d_model), 11, scale=1.0)
    want = JL.gqa_attention(jp, jnp.asarray(x), a)
    got, k, v = L.gqa_attention(tp, torch.from_numpy(x),
                                get_arch("stablelm-12b").reduced.attention)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # k and v as JAX's lm_prefill computes them for its cache
    kv_shape = (2, 40, a.n_kv_heads, a.head_dim)
    pos = jnp.broadcast_to(jnp.arange(40), (2, 40))
    want_k = JL.apply_rope((jnp.asarray(x) @ jp["wk"]).reshape(kv_shape), pos, a.rope_theta)
    want_v = (jnp.asarray(x) @ jp["wv"]).reshape(kv_shape)
    np.testing.assert_allclose(k.numpy(), np.asarray(want_k), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), atol=1e-5)


def test_rope_matches_jax():
    x = _normal((2, 9, 3, 16), 12, scale=1.0)
    pos = np.random.default_rng(13).integers(0, 500, size=(2, 9))
    for theta in (10000.0, 5000000.0):
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # bf16 in, bf16 out, computed in f32
    got = L.apply_rope(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos), 1e4)
    want = JL.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), 1e4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)


@pytest.mark.parametrize("mlp_type,act", [("swiglu", "silu"), ("mlp", "relu2"),
                                          ("mlp", "gelu")])
def test_mlp_matches_jax(mlp_type, act):
    jp = JL.init_mlp(jax.random.PRNGKey(4), 32, 80, mlp_type)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = _normal((2, 5, 32), 14, scale=1.0)
    want = JL.apply_mlp(jp, jnp.asarray(x), mlp_type, act)
    got = L.apply_mlp(tp, torch.from_numpy(x), mlp_type, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_gqa_decode_output_and_cache_match_jax():
    cfg = jget_arch("yi-34b").reduced  # 8 heads over 2 kv heads, hd 8
    jp, tp = _attn_params(cfg.attention, cfg.d_model, 5)
    ck, cv = _normal((2, 12, 2, 8), 15), _normal((2, 12, 2, 8), 16)
    x = _normal((2, 1, cfg.d_model), 17, scale=1.0)
    for pos in (0, 6, 11):
        want, jk, jv = JL.gqa_decode(jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(pos, jnp.int32), cfg.attention)
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        got, gk, gv = L.gqa_decode(tp, torch.from_numpy(x), tk, tv, pos,
                                   get_arch("yi-34b").reduced.attention)
        assert gk is tk and gv is tv  # written in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(gk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(gv.numpy(), np.asarray(jv), atol=1e-5)


def test_naive_attention_matches_jax_with_kv_len():
    q = _normal((2, 3, 4, 8), 18)
    k, v = _normal((2, 10, 2, 8), 19), _normal((2, 10, 2, 8), 20)
    kk, vv = (JL._repeat_kv(jnp.asarray(x), 2) for x in (k, v))
    for causal, q_offset, kv_len in ((False, 0, 7), (True, 5, None), (True, 0, 3)):
        want = JL.naive_attention(jnp.asarray(q), kk, vv, causal=causal, q_offset=q_offset,
                                  kv_len=kv_len)
        got = L.naive_attention(*_t(q, k, v), causal=causal, q_offset=q_offset,
                                kv_len=kv_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# the backbone: prefill and decode
# ---------------------------------------------------------------------------


def _backbone_pair(arch, seed=0, **overrides):
    jcfg = dataclasses.replace(jget_arch(arch).reduced, **overrides)
    tcfg = dataclasses.replace(get_arch(arch).reduced, **overrides)
    jp = JT.init_lm_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp))


def _run_both(jcfg, tcfg, jp, tp, steps=4, batch=2, prompt=8, cache_len=12):
    """Prefill then ``steps`` decode steps on the same embeddings in both
    packages: [(jax logits, port logits)], and the final caches."""
    rng = np.random.default_rng(21)
    emb = rng.normal(size=(batch, prompt, jcfg.d_model)).astype(np.float32) * 0.5
    jl, jc = JT.lm_prefill(jp, jcfg, jnp.asarray(emb), cache_len=cache_len)
    tl, tc = TT.lm_prefill(tp, tcfg, torch.from_numpy(emb), cache_len=cache_len)
    pairs = [(jl, tl)]
    prefill_caches = ([np.asarray(jc.caches[0][n]) for n in "kv"],
                      [tc.caches[0][n].clone() for n in "kv"])
    for _ in range(steps):
        e = rng.normal(size=(batch, 1, jcfg.d_model)).astype(np.float32) * 0.5
        jl, jc = JT.lm_decode_step(jp, jcfg, jnp.asarray(e), jc)
        tl, tc = TT.lm_decode_step(tp, tcfg, torch.from_numpy(e), tc)
        pairs.append((jl, tl))
    return pairs, prefill_caches, (jc, tc)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = _backbone_pair(arch)
    pairs, (jpre, tpre), (jc, tc) = _run_both(jcfg, tcfg, jp, tp)
    for jl, tl in pairs:
        assert tl.dtype == torch.float32 and tl.shape == (2, jcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    for a, b in zip(jpre, tpre):
        assert b.shape == (jcfg.n_layers, 2, 12, jcfg.attention.n_kv_heads,
                           jcfg.attention.head_dim)
        np.testing.assert_allclose(b.numpy(), a, atol=1e-5)
    assert tc.length == int(jc.length) == 12
    for n in "kv":
        np.testing.assert_allclose(tc.caches[0][n].numpy(), np.asarray(jc.caches[0][n]),
                                   atol=1e-5)


def test_bf16_compute_matches_jax():
    """Reduced stablelm-12b with f32 params computing in bf16: the weights,
    caches and activations are rounded to bf16 in both packages, at places
    that differ (XLA fuses and keeps f32 between some ops, torch rounds each
    op's output), so the logits agree to bf16 precision: within 3% of the
    largest |logit|, and the caches within 2% of theirs (0.7-0.9% of each
    measured on the CPU)."""
    jcfg, tcfg, jp, tp = _backbone_pair("stablelm-12b", compute_dtype="bfloat16")
    pairs, (jpre, tpre), _ = _run_both(jcfg, tcfg, jp, tp)
    for jl, tl in pairs:
        assert tl.dtype == torch.float32
        scale = float(np.abs(np.asarray(jl)).max())
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= 0.03 * scale
    for a, b in zip(jpre, tpre):
        assert b.dtype == torch.bfloat16
        a = np.asarray(jnp.asarray(a, jnp.float32))
        assert float(np.abs(b.float().numpy() - a).max()) <= 0.02 * float(np.abs(a).max())


# ---------------------------------------------------------------------------
# the session, conversion, CLI
# ---------------------------------------------------------------------------


def test_session_serve_tokens_equal_jax():
    """Reduced stablelm-12b, batch 2, prompt 8, gen 4: the port serves JAX's
    own fresh init (params from ``PRNGKey(seed)``, table from
    ``PRNGKey(1)``, as JAX's ``serve`` draws them) and generates its tokens."""
    arch, seed = "stablelm-12b", 0
    jsess = JSession.from_arch(arch, reduced=True, seed=seed)
    jrep = jsess.serve(batch=2, prompt_len=8, gen=4)
    jcfg = jget_arch(arch).reduced
    jp = JT.init_lm_params(jax.random.PRNGKey(seed), jcfg)
    jspec = jmake_spec(None, vocab_size=jcfg.vocab_size, dim=jcfg.d_model, num_shards=1)
    jtable = jinit_table(jax.random.PRNGKey(1), jspec, None, ("data",))

    sess = Session.from_arch(arch, reduced=True, seed=seed, device="cpu")
    sess.ingest(lm_params_from_jax(jax.tree.map(np.asarray, jp)),
                table_from_jax(np.asarray(jtable.rows), np.asarray(jtable.accum), "cpu"))
    rep = sess.serve(batch=2, prompt_len=8, gen=4)
    assert rep.tokens.shape == (2, 4)
    np.testing.assert_array_equal(rep.tokens, jrep.tokens)
    assert set(jrep.summary) <= set(rep.summary)
    assert rep.summary["device"] == "cpu"


def test_fresh_serve_is_seeded_and_kept():
    sess = Session.from_arch("stablelm-3b", reduced=True, seed=3, device="cpu")
    a = sess.serve(batch=2, prompt_len=5, gen=3)
    params = sess.lm_weights()[0]
    b = sess.serve(batch=2, prompt_len=5, gen=3)
    assert sess.lm_weights()[0] is params  # drawn once per seed
    np.testing.assert_array_equal(a.tokens, b.tokens)
    other = Session.from_arch("stablelm-3b", reduced=True, seed=3, device="cpu")
    np.testing.assert_array_equal(other.serve(batch=2, prompt_len=5, gen=3).tokens,
                                  a.tokens)


def test_lm_params_from_jax_names_shapes_and_dtypes():
    jcfg = dataclasses.replace(jget_arch("stablelm-12b").reduced, param_dtype="bfloat16")
    jp = JT.init_lm_params(jax.random.PRNGKey(2), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    n, d, f, v = jcfg.n_layers, jcfg.d_model, jcfg.d_ff, jcfg.vocab_size
    hq = jcfg.attention.n_heads * jcfg.attention.head_dim
    hkv = jcfg.attention.n_kv_heads * jcfg.attention.head_dim
    want = {"blocks.0.norm1.scale": (n, d), "blocks.0.norm2.scale": (n, d),
            "blocks.0.attn.wq": (n, d, hq), "blocks.0.attn.wk": (n, d, hkv),
            "blocks.0.attn.wv": (n, d, hkv), "blocks.0.attn.wo": (n, hq, d),
            "blocks.0.mlp.wi": (n, d, f), "blocks.0.mlp.wg": (n, d, f),
            "blocks.0.mlp.wo": (n, f, d), "final_norm.scale": (d,), "head_w": (d, v)}
    assert {k: tuple(x.shape) for k, x in tp.items()} == want
    for k, x in tp.items():
        assert x.dtype == (torch.float32 if "norm" in k else torch.bfloat16), k
    leaf = np.asarray(jp["blocks"][0]["attn"]["wq"]).astype(np.float32)
    np.testing.assert_array_equal(tp["blocks.0.attn.wq"].float().numpy(), leaf)
    # the port's own init has the same names, shapes and dtypes
    own = TT.init_lm_params(dataclasses.replace(get_arch("stablelm-12b").reduced,
                                                param_dtype="bfloat16"),
                            device="cpu", generator=torch.Generator())
    assert {k: (tuple(x.shape), x.dtype) for k, x in own.items()} == \
        {k: (tuple(x.shape), x.dtype) for k, x in tp.items()}


def test_lm_session_refuses_to_train_and_recsys_serving():
    """An LM session trains (its state drawn on first use, one step of the
    next-token loss); it refuses recsys serving, a recsys session refuses
    LM serving, and mismatched weights and unported archs are refused."""
    sess = Session.from_arch("stablelm-12b", reduced=True, device="cpu",
                             global_batch=4, seq_len=8)
    assert sess._state is None and int(sess.state.step) == 0
    rep = sess.train(1)
    assert int(rep.state.step) == 1 and np.isfinite(rep.stats.losses).all()
    assert rep.summary["tokens_per_s"] > 0
    with pytest.raises(ValueError, match=r"\.serve\(\)"):
        sess.serve_embeddings(num_requests=4)
    with pytest.raises(ValueError, match="serve_embeddings"):
        Session.from_arch("dlrm-ctr", reduced=True, device="cpu").serve()
    with pytest.raises(ValueError, match="do not match"):
        sess.ingest({"head_w": torch.zeros(3)}, sess.lm_weights()[1])
    with pytest.raises(KeyError, match="ported"):
        get_arch("no-such-arch")


def test_lm_cli_serves_on_cpu(capsys):
    from repro_torch.launch.serve import serve

    tokens = serve(["--arch", "nemotron-4-340b", "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert tokens.shape == (2, 3)
    out = capsys.readouterr().out
    assert '"arch": "nemotron-4-340b"' in out and '"device": "cpu"' in out
