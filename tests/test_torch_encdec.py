"""The port's encoder-decoder (``models.encdec``, ``whisper-base``) against
the JAX package on the CPU, at ``whisper-base-reduced`` (2 + 2 layers,
d_model 64, 4 heads of 16, 24 frames, vocab 512), f32 unless a test says
otherwise.

- ``run_encoder``, and the cross attention at Tq != Tm, within 1e-5;
- ``make_encdec_loss_fn``'s loss and every gradient (every dense param
  and the embeddings) against ``jax.value_and_grad`` within 1e-5; in
  bf16, the loss and each gradient within 3% of the largest magnitude of
  JAX's bf16 one (JAX's bf16 ``naive_attention`` rounds its scores to bf16,
  the port's do not), and farther from the port's f32 ones than f32
  rounding;
- a prefill and 3 decode steps within 1e-5, the cache's shapes and dtypes
  those of JAX's ``EncDecCache``; a prefill of T and one decode step
  against a prefill of T + 1;
- the stream's windows (keys, labels, frames) equal to JAX's stream's bit
  for bit for a seed and a step;
- 3-step ``Session.train`` trajectories in nestpipe and serial against
  JAX's within ``atol=1e-5`` (AdamW eps 1e-6), nestpipe = serial = the
  port's reference trainer, async diverges;
- served tokens equal to JAX's ``Session.serve`` on the same weights and
  frames;
- ``convert`` carries every leaf's name, shape, dtype and bits; a reduced
  whisper state saves and restores to the same bits.

Every input is drawn with numpy from a seed and handed to both packages.
"""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.api import Session as JSession
from repro.api.streams import resolve_stream as jresolve_stream
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import ParallelConfig
from repro.configs.registry import get_arch as jget_arch
from repro.core.embedding.table import init_table_state as jinit_table
from repro.core.embedding.table import make_mega_table_spec as jmake_spec
from repro.models import encdec as JE
from repro_torch.api import Session, resolve_stream
from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax, table_from_jax, train_state_from_jax
from repro_torch.core.consistency import build_reference_step
from repro_torch.data.pipeline import make_cluster_transform, stage_to_device
from repro_torch.dist import checkpoint as ck
from repro_torch.models import encdec as TE
from repro_torch.train import clone_state, constant_lr

ARCH = "whisper-base"  # reduced: 2 + 2 layers, d_model 64, 4 heads of 16, 24 frames
KW = dict(reduced=True, global_batch=8, seq_len=16, n_micro=2, t_chunk=32)
LR, ADAM_EPS = 2e-3, 1e-6
STEPS = 3
MODES = ("nestpipe", "serial", "async")
BF16_RTOL = 0.03
# XLA's backend optimisations off: each JAX graph here runs a few times at
# most, and compiling it is most of its time
_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are small, and with the
    suite's workers sharing the cores more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.array(x, copy=True)  # a JAX run donates its input buffers


def _f32(x):
    if isinstance(x, jax.Array):
        return np.asarray(jnp.asarray(x, jnp.float32))
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _max_diff(a, b):
    return float(np.max(np.abs(_f32(a).astype(np.float64) - _f32(b).astype(np.float64))))


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    """JAX's init of the reduced encoder-decoder from ``PRNGKey(seed)``, as
    numpy: drawn once for the tests that share it."""
    return jax.tree.map(np.asarray, JE.init_encdec_params(jax.random.PRNGKey(seed),
                                                          jget_arch(ARCH).reduced))


def _cfgs(**overrides):
    return (dataclasses.replace(jget_arch(ARCH).reduced, **overrides),
            dataclasses.replace(get_arch(ARCH).reduced, **overrides))


def _inputs(seed, b, t, cfg):
    """Token embeddings (B, T, D) and frames (B, n_frames, enc_d), f32."""
    rng = np.random.default_rng(seed)
    emb = (rng.normal(size=(b, t, cfg.d_model)) * 0.5).astype(np.float32)
    frames = (rng.normal(size=(b, cfg.encoder.n_frames, cfg.d_model)) * 0.5).astype(np.float32)
    return emb, frames


# ---------------------------------------------------------------------------
# the encoder, the cross attention, the loss
# ---------------------------------------------------------------------------


def test_encoder_and_cross_attention_match_jax():
    """The encoder over 24 frames (non-causal self-attention), and layer 0's
    cross attention of 11 queries against its 24 memory positions (JAX's
    memory k and v repeated to H heads, the port's read in place)."""
    jcfg, tcfg = _cfgs()
    jp = _jax_params()
    tp = lm_params_from_jax(jp)
    emb, frames = _inputs(1, 2, 11, jcfg)
    jmem = _jit(lambda p, f: JE.run_encoder(p, jcfg, f))(jp, jnp.asarray(frames))
    tmem = TE.run_encoder(tp, tcfg, torch.from_numpy(frames))
    assert tmem.shape == jmem.shape == (2, 24, 64) and tmem.dtype == torch.float32
    assert _max_diff(tmem, jmem) <= 1e-5

    jx = jax.tree.map(lambda v: jnp.asarray(v[0]), jp["decoder"]["xattn"])
    tx = {k.split(".")[-1]: v[0] for k, v in tp.items() if k.startswith("decoder.xattn.")}

    def jcross(p, x, mem):
        mk, mv = JE._memory_kv(p, mem, jcfg.attention)
        return JE._cross_attention(p, x, mk, mv, jcfg.attention)

    want = _jit(jcross)(jx, jnp.asarray(emb), jmem)
    mk, mv = TE._memory_kv(tx, tmem, tcfg.attention)
    assert mk.shape == mv.shape == (2, 24, 4, 16)
    got = TE._cross_attention(tx, torch.from_numpy(emb), mk, mv, tcfg.attention)
    plain = TE._cross_attention(tx, torch.from_numpy(emb), mk, mv, tcfg.attention,
                                decode=True)
    assert got.shape == want.shape == (2, 11, 64)
    assert _max_diff(got, want) <= 1e-5 and _max_diff(plain, want) <= 1e-5


@functools.lru_cache(maxsize=None)
def _loss_pair(compute_dtype="float32"):
    """JAX's and the port's (loss, param grads, emb grad) on one batch of 2
    x 40 tokens against 24 frames (chunk 16: three chunks, the last
    padded), JAX's params."""
    jcfg, tcfg = _cfgs(compute_dtype=compute_dtype)
    jp = _jax_params()
    emb, frames = _inputs(7, 2, 40, jcfg)
    labels = np.random.default_rng(8).integers(0, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
    labels[1, -2:] = -1
    jloss = JE.make_encdec_loss_fn(jcfg, ParallelConfig(), None, t_chunk=16)
    (jtotal, jmet), (jg, jge) = _jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                        has_aux=True))(
        jp, jnp.asarray(emb), {"frames": jnp.asarray(frames), "labels": jnp.asarray(labels)})
    assert set(jmet) == {"xent"}
    tp = {k: v.requires_grad_() for k, v in lm_params_from_jax(jp).items()}
    temb = torch.from_numpy(emb).requires_grad_()
    total, met = TE.make_encdec_loss_fn(tcfg, t_chunk=16)(
        tp, temb, {"frames": torch.from_numpy(frames), "labels": torch.from_numpy(labels)})
    assert set(met) == {"xent"} and float(met["xent"]) == float(total.detach())
    grads = torch.autograd.grad(total, [*tp.values(), temb])
    jgrads = {k: _f32(v) for k, v in lm_params_from_jax(jax.tree.map(np.asarray, jg)).items()}
    return ((float(jtotal), jgrads, _f32(jge)),
            (float(total.detach()), {k: _f32(g) for k, g in zip(tp, grads[:-1])},
             _f32(grads[-1])))


def test_loss_and_grads_match_jax_value_and_grad():
    (jtotal, jgrads, jge), (total, grads, ge) = _loss_pair()
    assert abs(total - jtotal) <= 1e-5
    assert set(grads) == set(jgrads)
    assert {"encoder.attn.wq", "decoder.xattn.wk", "enc_norm.bias"} <= set(grads)
    for k, g in grads.items():
        assert g.shape == jgrads[k].shape, k
        assert np.abs(jgrads[k]).max() > 0, k  # every leaf is on the loss's path
        assert _max_diff(g, jgrads[k]) <= 1e-5, k
    assert _max_diff(ge, jge) <= 1e-5


def test_bf16_compute_loss_and_grads_match_jax():
    """f32 params computing in bf16 (``_cast_tree`` rounds the stacked
    LayerNorm scales and biases and ``head_w``; ``enc_norm`` and
    ``final_norm`` stay f32): the loss and each gradient within 3% of the
    largest magnitude of JAX's bf16 ones, and each farther from the port's
    f32 one than f32 rounding."""
    (jf, _, _), (tf, tgf, tgef) = _loss_pair()
    (jb, jgb, jgeb), (tb, tgb, tgeb) = _loss_pair("bfloat16")
    assert abs(tb - jb) <= BF16_RTOL * abs(jb) and abs(jb - jf) <= BF16_RTOL * abs(jf)
    assert abs(tb - tf) > 100 * np.finfo(np.float32).eps * abs(tf)
    for k, want in [*jgb.items(), ("emb", jgeb)]:
        got, f32 = (tgeb, tgef) if k == "emb" else (tgb[k], tgf[k])
        assert _max_diff(got, f32) > 1e-3 * float(np.abs(f32).max()), k
        assert _max_diff(got, want) <= BF16_RTOL * float(np.abs(want).max()), k


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_jax():
    """The prefill's logits and caches, then 3 decode steps, within 1e-5;
    the caches' shapes and dtypes are those of JAX's ``EncDecCache``
    (KV = H: JAX's memory cache repeats the kv heads, a no-op here)."""
    jcfg, tcfg = _cfgs()
    jp = _jax_params()
    tp = lm_params_from_jax(jp)
    emb, frames = _inputs(21, 2, 9, jcfg)
    jl, jc = _jit(lambda p, e, f: JE.encdec_prefill(p, jcfg, e, f, cache_len=12))(
        jp, jnp.asarray(emb), jnp.asarray(frames))
    tl, tc = TE.encdec_prefill(tp, tcfg, torch.from_numpy(emb), torch.from_numpy(frames),
                               cache_len=12)
    assert _max_diff(tl, jl) <= 1e-5 and tc.length == int(jc.length) == 9
    names = ("self_k", "self_v", "mem_k", "mem_v")
    for n in names:
        t_, j_ = getattr(tc, n), getattr(jc, n)
        assert (tuple(t_.shape), str(t_.dtype).removeprefix("torch.")) == \
            (tuple(j_.shape), str(j_.dtype)), n
        assert _max_diff(t_, j_) <= 1e-5, n
    decode = _jit(lambda p, e, c: JE.encdec_decode_step(p, jcfg, e, c))
    rng = np.random.default_rng(22)
    for _ in range(3):
        e = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32) * 0.5
        jl, jc = decode(jp, jnp.asarray(e), jc)
        tl, tc = TE.encdec_decode_step(tp, tcfg, torch.from_numpy(e), tc)
        assert tl.shape == (2, jcfg.vocab_size) and _max_diff(tl, jl) <= 1e-5
    assert tc.length == int(jc.length) == 12
    for n in names:
        assert _max_diff(getattr(tc, n), getattr(jc, n)) <= 1e-5, n


def test_prefill_and_a_decode_step_equal_the_longer_prefill():
    """A prefill of 9 and one decode step against a prefill of 10 on the
    same prompt and frames: the self caches and the memory caches carried."""
    _, tcfg = _cfgs()
    tp = lm_params_from_jax(_jax_params())
    emb, frames = (torch.from_numpy(x) for x in _inputs(5, 2, 10, tcfg))
    with torch.inference_mode():
        _, cache = TE.encdec_prefill(tp, tcfg, emb[:, :9], frames, cache_len=10)
        step, cache = TE.encdec_decode_step(tp, tcfg, emb[:, 9:], cache)
        whole, _ = TE.encdec_prefill(tp, tcfg, emb, frames)
    assert cache.length == 10
    assert _max_diff(step, whole) <= 1e-5 * max(1.0, float(whole.abs().max()))


# ---------------------------------------------------------------------------
# the stream; Session.train against JAX's; serving; convert; checkpoints
# ---------------------------------------------------------------------------


def test_stream_frames_equal_jax_s_bit_for_bit():
    """Steps 0 and 3 of seed 5: keys, labels and the (8, 24, 64) f32 frames
    of JAX's stream, bit for bit."""
    jwl = JSession.from_arch(ARCH, reduced=True, global_batch=8, seq_len=16).workload
    wl = Session.from_arch(ARCH, device="cpu", **KW).workload
    assert wl.batch_shapes["frames"] == ((2, 4, 24, 64), torch.float32)
    for step in (0, 3):
        want = next(jresolve_stream(jwl, 5, start_step=step))
        got = next(resolve_stream(wl, 5, start_step=step))
        assert got["frames"].dtype == np.float32 and got["frames"].shape == (8, 24, 64)
        for k in ("keys", "labels", "frames"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _port_session(init_np, mode):
    sess = Session.from_arch(ARCH, mode=mode, device="cpu",
                             opt_cfg=OptimizerConfig(lr=LR, eps=ADAM_EPS), **KW)
    sess.state = train_state_from_jax(init_np, "cpu")
    return sess


@pytest.fixture(scope="module")
def encdec_runs():
    """Per mode: JAX's initial state (one draw), JAX's run (nestpipe and
    serial), and the port's run from that state."""
    out, init = {}, None
    for mode in MODES:
        jrep = None
        if mode != "async":
            jsess = JSession.from_arch(ARCH, mode=mode, store="device",
                                       opt_cfg=JOptimizerConfig(lr=LR, eps=ADAM_EPS), **KW)
            init = jax.tree.map(_np, jsess.state) if init is None else init
            jrep = jsess.train(STEPS)
        rep = _port_session(init, mode).train(STEPS)
        out[mode] = (init, jrep, rep)
    return out


@pytest.mark.parametrize("mode", ["nestpipe", "serial"])
def test_encdec_trajectory_matches_jax(encdec_runs, mode):
    _, jrep, rep = encdec_runs[mode]
    jstate = jax.tree.map(_np, jrep.state)
    assert rep.summary["arch"] == ARCH and rep.summary["overflow_max"] == 0
    assert rep.summary["tokens_per_s"] == rep.summary["samples_per_s"] * 16
    np.testing.assert_allclose(rep.stats.losses, jrep.stats.losses, rtol=0, atol=1e-5)
    jdense = lm_params_from_jax(jstate.dense)
    assert set(jdense) == set(rep.state.dense)
    for k, v in jdense.items():
        assert _max_diff(rep.state.dense[k], v) <= 1e-5, k
    assert _max_diff(rep.state.table.rows, jstate.table.rows) <= 1e-5
    assert _max_diff(rep.state.table.accum, jstate.table.accum) <= 1e-5
    assert int(rep.state.step) == int(jstate.step) == STEPS


def _gap(a, b):
    return max([_max_diff(a.table.rows, b.table.rows),
                _max_diff(a.table.accum, b.table.accum)]
               + [_max_diff(a.dense[k], b.dense[k]) for k in a.dense])


def test_encdec_nestpipe_equals_serial_equals_reference_async_diverges(encdec_runs):
    init = encdec_runs["nestpipe"][0]
    sess = _port_session(init, "nestpipe")
    wl = sess.workload
    ref_step = build_reference_step(wl.bundle.loss_fn(wl.t_chunk), sess.optimizer,
                                    constant_lr(sess.opt_cfg.lr), wl.n_micro)
    transform = make_cluster_transform(wl.n_micro, "keycentric")
    stream = resolve_stream(wl, sess.seed)
    ref = clone_state(train_state_from_jax(init, "cpu"))
    for _ in range(STEPS):
        batch = transform(next(stream))
        assert batch["frames"].shape == (2, 4, 24, 64)
        ref, _ = ref_step(ref, stage_to_device({k: batch[k] for k in wl.batch_shapes},
                                               torch.device("cpu")))
    nest, serial = encdec_runs["nestpipe"][2].state, encdec_runs["serial"][2].state
    assert _gap(nest, ref) <= 1e-5 and _gap(serial, ref) <= 1e-5 and _gap(nest, serial) <= 1e-5
    assert _max_diff(encdec_runs["async"][2].state.table.rows, ref.table.rows) > 1e-6


def test_session_serve_tokens_equal_jax():
    """Reduced, batch 2, prompt 8, gen 4, on JAX's own fresh init (params
    from ``PRNGKey(seed)``, table from ``PRNGKey(1)``, frames from the
    serve's rng after the prompts)."""
    seed = 0
    jrep = JSession.from_arch(ARCH, reduced=True, seed=seed).serve(batch=2, prompt_len=8,
                                                                  gen=4)
    jcfg = jget_arch(ARCH).reduced
    jspec = jmake_spec(None, vocab_size=jcfg.vocab_size, dim=jcfg.d_model, num_shards=1)
    jtable = jinit_table(jax.random.PRNGKey(1), jspec, None, ("data",))
    sess = Session.from_arch(ARCH, reduced=True, seed=seed, device="cpu")
    sess.ingest(lm_params_from_jax(_jax_params(seed)),
                table_from_jax(np.asarray(jtable.rows), np.asarray(jtable.accum), "cpu"))
    rep = sess.serve(batch=2, prompt_len=8, gen=4)
    assert rep.tokens.shape == (2, 4)
    np.testing.assert_array_equal(rep.tokens, jrep.tokens)


def test_convert_carries_every_encdec_leaf():
    """JAX's reduced init: every leaf under the port's name (``encoder.*``,
    ``decoder.*``, ``enc_norm.*``, ``final_norm.*``, ``head_w``), its shape,
    dtype and bits; the port's own init has the same names, shapes and
    dtypes."""
    jp = _jax_params()
    tp = lm_params_from_jax(jp)
    flat = {jax.tree_util.keystr(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert len(flat) == len(tp) == 10 + 16 + 4 + 1  # encoder, decoder, norms, head
    for path, leaf in flat.items():
        name = path.replace("']['", ".").strip("[']")
        assert tuple(tp[name].shape) == leaf.shape and tp[name].dtype == torch.float32, name
        np.testing.assert_array_equal(tp[name].numpy(), leaf, err_msg=name)
    assert tp["encoder.attn.wq"].shape == (2, 64, 64)
    assert tp["decoder.xattn.wo"].shape == (2, 64, 64)
    assert tp["enc_norm.bias"].shape == (64,) and tp["head_w"].shape == (64, 512)
    own = TE.init_encdec_params(get_arch(ARCH).reduced, device="cpu",
                                generator=torch.Generator())
    assert {k: (tuple(x.shape), x.dtype) for k, x in own.items()} == \
        {k: (tuple(x.shape), x.dtype) for k, x in tp.items()}


def test_encdec_state_saves_and_restores_the_same_bits(tmp_path):
    """A reduced whisper session trains 2 steps and saves; a session from
    another seed restores it (every leaf the same bits) and both train 2
    more to the same losses and leaves."""
    d = str(tmp_path)
    kw = dict(reduced=True, device="cpu", global_batch=8, seq_len=16, data_seed=0,
              ckpt_dir=d)
    a = Session.from_arch(ARCH, **kw)
    a.train(2)
    a.save()
    b = Session.from_arch(ARCH, seed=1, **kw)
    assert int(b.restore().step) == 2
    la, lb = ck.flatten_state(a.state), ck.flatten_state(b.state)
    assert [p for p, _ in la] == [p for p, _ in lb]
    assert any("['encoder." in p for p, _ in la) and any("['enc_norm." in p for p, _ in la)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert b.train(2).stats.losses == a.train(2).stats.losses
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(ck.flatten_state(a.state), ck.flatten_state(b.state)))
