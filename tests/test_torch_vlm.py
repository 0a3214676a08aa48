"""The port's vision-language LM (``pixtral-12b``: the decoder-only stack
behind stub patch embeddings) against the JAX package on the CPU, at
``pixtral-12b-reduced`` (2 layers, d_model 64, 4 heads of 16 over 2, 8
patches, vocab 512, f32).

- ``stub_frontend_embeddings`` is JAX's draw bit for bit;
- the prefill over ``concat(patches, emb)`` into a cache of ``n_positions
  + prompt_len + gen`` positions, and every decode step's logits and
  tokens, against JAX's ``lm_prefill`` / ``lm_decode_step`` within 1e-5;
  ``Session.serve``'s tokens equal those of that JAX run on the same
  weights, prompts and patches (drawn in JAX's order);
- JAX's ``Session.serve`` sizes a VLM's cache ``prompt_len + gen``: at
  ``gen < n_positions`` it raises, where the port serves (the trap is
  pinned, not repaired: the JAX package stays as it is);
- the VLM loss and every gradient against JAX's ``build_model(...).loss_fn``
  within 1e-5; the window's shapes, and a ``seq_len`` that leaves no text
  refused;
- the stream's windows (keys, the -1 label pad over the patches, zero
  patches) equal to JAX's stream's bit for bit;
- 3-step ``Session.train`` trajectories in nestpipe and serial against
  JAX's within ``atol=1e-5`` (AdamW eps 1e-6), nestpipe = serial = the
  port's reference trainer, async diverges;
- ``convert`` carries JAX's pixtral params with the LM mapping.

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
from repro.models import frontend as JF
from repro.models import transformer as JT
from repro.models.zoo import build_model as jbuild_model
from repro_torch.api import Session, resolve_stream
from repro_torch.configs import base as tbase
from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax, table_from_jax, train_state_from_jax
from repro_torch.core.consistency import build_reference_step
from repro_torch.data.pipeline import make_cluster_transform, stage_to_device
from repro_torch.models import frontend as TF
from repro_torch.models import transformer as TT
from repro_torch.models.zoo import build_lm_bundle, train_batch_shapes
from repro_torch.train import clone_state, constant_lr

ARCH = "pixtral-12b"  # reduced: 2 layers, d_model 64, 4 heads of 16 over 2, 8 patches
KW = dict(reduced=True, global_batch=8, seq_len=24, n_micro=2, t_chunk=16)
LR, ADAM_EPS = 2e-3, 1e-6
STEPS = 3
MODES = ("nestpipe", "serial", "async")
N_P = 8  # the reduced config's patches
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
def _jax_weights(seed=0):
    """JAX's own fresh init of the reduced VLM, as its serve draws it:
    params from ``PRNGKey(seed)``, the table from ``PRNGKey(1)``; numpy."""
    jcfg = jget_arch(ARCH).reduced
    jp = jax.tree.map(np.asarray, JT.init_lm_params(jax.random.PRNGKey(seed), jcfg))
    jspec = jmake_spec(None, vocab_size=jcfg.vocab_size, dim=jcfg.d_model, num_shards=1)
    jtable = jinit_table(jax.random.PRNGKey(1), jspec, None, ("data",))
    return jp, np.asarray(jtable.rows), np.asarray(jtable.accum)


# ---------------------------------------------------------------------------
# the frontend stub; prefill and decode; serving and JAX's serve trap
# ---------------------------------------------------------------------------


def test_stub_frontend_embeddings_are_jax_s_bits():
    cfg, jcfg = get_arch(ARCH).reduced, jget_arch(ARCH).reduced
    assert TF.frontend_embed_shape(cfg, 3) == JF.frontend_embed_shape(jcfg, 3) == (3, N_P, 64)
    got = TF.stub_frontend_embeddings(cfg, 3, seed=4, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(JF.stub_frontend_embeddings(jcfg, 3,
                                                                                     seed=4)))


def _jax_greedy(jp, rows, keys_np, patches_np, gen, jspec):
    """JAX's model functions on JAX's lookups: the prefill over
    ``concat(patches, emb)`` into ``n_positions + prompt_len + gen``
    positions, then ``gen - 1`` greedy decode steps. Returns the logits of
    each call and the tokens."""
    jcfg = jget_arch(ARCH).reduced
    emb = jnp.asarray(rows[keys_np])
    full = jnp.concatenate([jnp.asarray(patches_np).astype(emb.dtype), emb], axis=1)
    cache_len = full.shape[1] + gen
    logits, cache = _jit(lambda p, e: JT.lm_prefill(p, jcfg, e, cache_len=cache_len))(jp, full)
    decode = _jit(lambda p, e, c: JT.lm_decode_step(p, jcfg, e, c))
    out, toks = [logits], [np.asarray(jnp.argmax(logits, -1)).astype(np.int32)]
    for _ in range(gen - 1):
        k = np.asarray(jspec.scramble(jnp.asarray(toks[-1][:, None])))
        logits, cache = decode(jp, jnp.asarray(rows[k]), cache)
        out.append(logits)
        toks.append(np.asarray(jnp.argmax(logits, -1)).astype(np.int32))
    assert int(cache.length) == cache_len - 1  # the last token is not fed back
    return out, np.stack(toks, axis=1)


def test_prefill_and_decode_over_the_patches_match_jax():
    """Batch 2, 8 patches and a prompt of 5, 4 generated: the prefill's
    logits, the cache's first positions and every decode step's logits
    within 1e-5 of JAX's on the same patches and embeddings, the same
    tokens; the cache holds the patches, the prompt and the generation."""
    jcfg, tcfg = jget_arch(ARCH).reduced, get_arch(ARCH).reduced
    jp, rows, _ = _jax_weights()
    tp = lm_params_from_jax(jp)
    jspec = jmake_spec(None, vocab_size=jcfg.vocab_size, dim=jcfg.d_model, num_shards=1)
    rng = np.random.default_rng(21)
    keys = np.asarray(jspec.scramble(jnp.asarray(
        rng.integers(0, jcfg.vocab_size, size=(2, 5)).astype(np.int32))))
    patches = (rng.normal(size=(2, N_P, jcfg.d_model)) * 0.5).astype(np.float32)
    jlogits, jtoks = _jax_greedy(jp, rows, keys, patches, 4, jspec)

    emb = torch.cat([torch.from_numpy(patches), torch.from_numpy(rows[keys])], dim=1)
    tl, tc = TT.lm_prefill(tp, tcfg, emb, cache_len=N_P + 5 + 4)
    assert tc.length == N_P + 5 and tc.caches[0]["k"].shape == (2, 2, 17, 2, 16)
    got, toks = [tl], [tl.argmax(-1).to(torch.int32)]
    for _ in range(3):
        k = np.asarray(jspec.scramble(jnp.asarray(toks[-1].numpy()[:, None])))
        tl, tc = TT.lm_decode_step(tp, tcfg, torch.from_numpy(rows[k]), tc)
        got.append(tl)
        toks.append(tl.argmax(-1).to(torch.int32))
    assert tc.length == N_P + 5 + 3
    assert len(got) == len(jlogits) == 4
    for a, b in zip(got, jlogits):
        assert a.shape == (2, jcfg.vocab_size) and _max_diff(a, b) <= 1e-5
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), jtoks)


def _port_serving_session(seed=0):
    jp, rows, accum = _jax_weights(seed)
    sess = Session.from_arch(ARCH, reduced=True, seed=seed, device="cpu")
    sess.ingest(lm_params_from_jax(jp), table_from_jax(rows, accum, "cpu"))
    return sess


@pytest.mark.parametrize("prompt_len,gen", [(8, 12), (16, 4)])
def test_session_serve_tokens_equal_jax_model_functions(prompt_len, gen):
    """Batch 2 on JAX's fresh init: the prompts, then the patches, drawn
    from one ``default_rng(seed)`` (JAX's serve's order), the prompts
    scrambled into master rows; the port's served tokens equal JAX's model
    functions' greedy run with the VLM's cache (``gen`` above and below
    the 8 patches)."""
    seed = 0
    jcfg = jget_arch(ARCH).reduced
    jp, rows, _ = _jax_weights(seed)
    jspec = jmake_spec(None, vocab_size=jcfg.vocab_size, dim=jcfg.d_model, num_shards=1)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, prompt_len))
    patches = np.asarray(jnp.asarray(rng.normal(size=(2, N_P, jcfg.d_model)),
                                     jnp.float32) * 0.02)
    keys = np.asarray(jspec.scramble(jnp.asarray(toks.astype(np.int32))))
    _, want = _jax_greedy(jp, rows, keys, patches, gen, jspec)
    rep = _port_serving_session(seed).serve(batch=2, prompt_len=prompt_len, gen=gen)
    assert rep.tokens.shape == (2, gen)
    np.testing.assert_array_equal(rep.tokens, want)


def test_jax_serve_raises_below_the_patch_count_where_the_port_serves():
    """JAX's ``Session.serve`` pads a VLM's cache by ``prompt_len + gen``
    minus the prefill's ``n_positions + prompt_len`` positions: negative at
    ``gen < n_positions``, where it raises. The port's cache holds all
    three, and it serves."""
    with pytest.raises(ValueError):
        JSession.from_arch(ARCH, reduced=True, seed=0).serve(batch=2, prompt_len=8, gen=4)
    rep = _port_serving_session().serve(batch=2, prompt_len=8, gen=4)
    assert rep.tokens.shape == (2, 4)
    assert ((0 <= rep.tokens) & (rep.tokens < jget_arch(ARCH).reduced.vocab_size)).all()


# ---------------------------------------------------------------------------
# the loss and its window
# ---------------------------------------------------------------------------


def test_vlm_loss_and_grads_match_jax_loss_fn():
    """JAX's ``build_model(...).loss_fn`` on 2 x (8 patches + 12 text
    positions), labels -1 over the patches and two more (chunk 16: two
    chunks, the last padded): the loss and the gradients of every dense
    param and of the text embeddings within 1e-5; the patches' gradient is
    not asked for, as in JAX."""
    jcfg, tcfg = jget_arch(ARCH).reduced, get_arch(ARCH).reduced
    jp, _, _ = _jax_weights()
    rng = np.random.default_rng(7)
    emb = (rng.normal(size=(2, 12, jcfg.d_model)) * 0.5).astype(np.float32)
    patches = (rng.normal(size=(2, N_P, jcfg.d_model)) * 0.5).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, size=(2, N_P + 12)).astype(np.int32)
    labels[:, :N_P] = -1
    labels[1, -2:] = -1
    jloss = jbuild_model(jget_arch(ARCH), ParallelConfig(), None, reduced=True,
                         t_chunk=16).loss_fn
    (jtotal, jmet), (jg, jge) = _jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(emb), {"patches": jnp.asarray(patches), "labels": jnp.asarray(labels)})
    tp = {k: v.requires_grad_() for k, v in lm_params_from_jax(jp).items()}
    temb = torch.from_numpy(emb).requires_grad_()
    total, met = build_lm_bundle(tcfg).loss_fn(16)(
        tp, temb, {"patches": torch.from_numpy(patches), "labels": torch.from_numpy(labels)})
    assert set(met) == set(jmet) and float(met["xent"]) == float(total.detach())
    assert abs(float(total.detach()) - float(jtotal)) <= 1e-5
    grads = torch.autograd.grad(total, [*tp.values(), temb])
    jgrads = lm_params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(jgrads) == set(tp)
    for (k, g) in zip(tp, grads[:-1]):
        assert np.abs(_f32(jgrads[k])).max() > 0, k  # every leaf is on the loss's path
        assert _max_diff(g, jgrads[k]) <= 1e-5, k
    assert grads[-1].shape == (2, 12, 64) and _max_diff(grads[-1], jge) <= 1e-5


def test_vlm_window_shapes_and_a_seq_len_with_no_text_refused():
    """The window of JAX's ``train_batch_shapes``: keys over the text,
    patches (N, mb, n_positions, d_model) f32, labels over every position;
    a ``seq_len`` not above the patch count raises. The decoder-only stack
    takes a vision frontend and refuses any other kind."""
    cfg = get_arch(ARCH).reduced
    assert train_batch_shapes(8, 24, 2, cfg) == {
        "keys": ((2, 4, 16), torch.int32), "patches": ((2, 4, N_P, 64), torch.float32),
        "labels": ((2, 4, 24), torch.int32)}
    for seq_len in (N_P, N_P - 3):
        with pytest.raises(ValueError, match="no text"):
            train_batch_shapes(8, seq_len, 2, cfg)
    TT._check_ported(cfg)
    audio = dataclasses.replace(cfg, frontend=tbase.FrontendConfig(kind="audio", n_positions=4))
    with pytest.raises(NotImplementedError, match="not ported"):
        TT._check_ported(audio)


def test_stream_windows_equal_jax_s_bit_for_bit():
    """Steps 0 and 3 of seed 5: text keys (8, 16), labels (8, 24) with -1
    over the 8 patch positions, zero patches (8, 8, 64) f32."""
    jwl = JSession.from_arch(ARCH, reduced=True, global_batch=8, seq_len=24).workload
    wl = Session.from_arch(ARCH, device="cpu", **KW).workload
    assert wl.batch_shapes["patches"] == ((2, 4, N_P, 64), torch.float32)
    for step in (0, 3):
        want = next(jresolve_stream(jwl, 5, start_step=step))
        got = next(resolve_stream(wl, 5, start_step=step))
        assert got["keys"].shape == (8, 16) and got["labels"].shape == (8, 24)
        assert (got["labels"][:, :N_P] == -1).all() and (got["labels"][:, N_P:] >= 0).all()
        assert got["patches"].dtype == np.float32 and not got["patches"].any()
        for k in ("keys", "labels", "patches"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# Session.train against JAX's; convert
# ---------------------------------------------------------------------------


def _port_session(init_np, mode):
    sess = Session.from_arch(ARCH, mode=mode, device="cpu",
                             opt_cfg=OptimizerConfig(lr=LR, eps=ADAM_EPS), **KW)
    sess.state = train_state_from_jax(init_np, "cpu")
    return sess


@pytest.fixture(scope="module")
def vlm_runs():
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
def test_vlm_trajectory_matches_jax(vlm_runs, mode):
    _, jrep, rep = vlm_runs[mode]
    jstate = jax.tree.map(_np, jrep.state)
    assert rep.summary["arch"] == ARCH and rep.summary["overflow_max"] == 0
    assert rep.summary["seq_len"] == 24
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


def test_vlm_nestpipe_equals_serial_equals_reference_async_diverges(vlm_runs):
    """The patches ride the window unchanged (the cluster transform permutes
    them with their samples) to the reference trainer's loss."""
    init = vlm_runs["nestpipe"][0]
    sess = _port_session(init, "nestpipe")
    wl = sess.workload
    ref_step = build_reference_step(wl.bundle.loss_fn(wl.t_chunk), sess.optimizer,
                                    constant_lr(sess.opt_cfg.lr), wl.n_micro)
    transform = make_cluster_transform(wl.n_micro, "keycentric")
    stream = resolve_stream(wl, sess.seed)
    ref = clone_state(train_state_from_jax(init, "cpu"))
    for _ in range(STEPS):
        batch = transform(next(stream))
        assert batch["patches"].shape == (2, 4, N_P, 64) and batch["labels"].shape == (2, 4, 24)
        ref, _ = ref_step(ref, stage_to_device({k: batch[k] for k in wl.batch_shapes},
                                               torch.device("cpu")))
    nest, serial = vlm_runs["nestpipe"][2].state, vlm_runs["serial"][2].state
    assert _gap(nest, ref) <= 1e-5 and _gap(serial, ref) <= 1e-5 and _gap(nest, serial) <= 1e-5
    assert _max_diff(vlm_runs["async"][2].state.table.rows, ref.table.rows) > 1e-6


def test_convert_carries_every_pixtral_leaf():
    """JAX's reduced init: every leaf under the LM mapping's name
    (``blocks.0.attn.wq`` ...), its shape, dtype and bits; the port's own
    init has the same names, shapes and dtypes."""
    jp, _, _ = _jax_weights()
    tp = lm_params_from_jax(jp)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(tp) == 4 + 3 + 2 + 1 + 1  # attn, mlp, norms, final norm, head
    for path, leaf in flat:
        name = ".".join(str(k.key if hasattr(k, "key") else k.idx) for k in path)
        assert tuple(tp[name].shape) == leaf.shape and tp[name].dtype == torch.float32, name
        np.testing.assert_array_equal(tp[name].numpy(), leaf, err_msg=name)
    assert tp["blocks.0.attn.wq"].shape == (2, 64, 64)
    assert tp["blocks.0.attn.wk"].shape == (2, 64, 32)
    own = TT.init_lm_params(get_arch(ARCH).reduced, device="cpu", generator=torch.Generator())
    assert {k: (tuple(x.shape), x.dtype) for k, x in own.items()} == \
        {k: (tuple(x.shape), x.dtype) for k, x in tp.items()}
