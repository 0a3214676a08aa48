"""The port's MoE (``models.layers`` MoE functions, the (attn, moe) LM)
against the JAX package on the CPU, at ``olmoe-1b-7b-reduced`` (8 experts
top-2) and ``grok-1-314b-reduced`` (4 experts top-2, GQA), f32.

- ``_topk_routing``: the same expert ids, weights within 1e-6;
  ``moe_aux_loss`` within 1e-6;
- the capacity: JAX's formula for every n, and the full config's 2,560
  (prefill, n 16,384), 1,280 (a training micro-batch, n 8,192) and 8
  (decode, n 8);
- ``apply_moe_slotted`` and ``apply_moe_dense``: output and aux within
  1e-5, and the gradients of a fixed projection of the output plus aux
  with respect to x, router, wi, wg and wo against ``jax.grad`` within
  1e-5; the slotted form at a capacity factor that drops tokens (the
  drops counted) and at the config's, which drops none; the slot plan's
  two index maps are each other's inverse;
- the whole LM: ``make_lm_loss_fn``'s loss, ``moe_aux`` (non-zero) and
  every gradient against ``jax.value_and_grad`` (loss and grads within
  1e-5, moe_aux within 1e-6); computing in bf16 within 3% of the largest
  magnitude of each (tests/test_torch_lm_train.py's bf16 tolerance);
  prefill and 3 decode steps within 1e-5;
- 3-step ``Session.train`` trajectories in nestpipe and serial against
  JAX's within ``atol=1e-5`` (AdamW eps 1e-6, as
  tests/test_torch_lm_train.py says why), nestpipe = serial = the port's
  reference trainer, async diverges; the per-step ``moe_aux`` positive;
- served tokens equal JAX's session's on the same weights;
- ``convert`` carries JAX's MoE leaves (``blocks.0.moe.router`` ...) with
  their names, shapes and dtypes, the router f32 in a bf16 model.

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
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import ParallelConfig
from repro.configs.registry import get_arch as jget_arch
from repro.core.embedding.table import init_table_state as jinit_table
from repro.core.embedding.table import make_mega_table_spec as jmake_spec
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.utils import round_up as jround_up
from repro_torch.api import Session, resolve_stream
from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax, table_from_jax, train_state_from_jax
from repro_torch.core.consistency import build_reference_step
from repro_torch.data.pipeline import make_cluster_transform, stage_to_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.train import clone_state, constant_lr

ARCHS = ["olmoe-1b-7b", "grok-1-314b"]
ARCH = "olmoe-1b-7b"  # reduced: 2 layers, d_model 64, 8 experts of d_ff 32, top-2
KW = dict(reduced=True, global_batch=8, seq_len=16, n_micro=2, t_chunk=32)
LR, ADAM_EPS = 2e-3, 1e-6
STEPS = 3
MODES = ("nestpipe", "serial", "async")
BF16_RTOL = 0.03


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
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.detach().to(torch.float32).numpy()


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(_f32(a) if isinstance(a, torch.Tensor) else a,
                                          np.float64)
                               - np.asarray(_f32(b) if isinstance(b, jax.Array) else b,
                                            np.float64))))


def _moe_pair(arch, capacity_factor=None, seed=0):
    """JAX's and the port's MoE config, JAX's init as numpy, and x (2, 24, d)."""
    jcfg, tcfg = jget_arch(arch).reduced, get_arch(arch).reduced
    jm, tm = jcfg.moe, tcfg.moe
    if capacity_factor is not None:
        jm = dataclasses.replace(jm, capacity_factor=capacity_factor)
        tm = dataclasses.replace(tm, capacity_factor=capacity_factor)
    p = JL.init_moe(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.d_ff, jm, jcfg.mlp_type)
    p = {k: np.asarray(v) for k, v in p.items()}
    x = np.random.default_rng(seed + 1).normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    return jcfg, jm, tm, p, x


# ---------------------------------------------------------------------------
# routing, the aux loss, the capacity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_topk_routing_and_aux_loss_match_jax(arch):
    jcfg, jm, tm, p, x = _moe_pair(arch)
    logits = x.reshape(-1, jcfg.d_model) @ p["router"]
    jids, jw = JL._topk_routing(jnp.asarray(logits), jm.top_k)
    ids, w = L._topk_routing(torch.from_numpy(logits), tm.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert w.dtype == torch.float32 and _max_diff(w, jw) <= 1e-6
    jaux = JL.moe_aux_loss(jnp.asarray(logits), jids, jm.num_experts)
    aux = L.moe_aux_loss(torch.from_numpy(logits), ids, tm.num_experts)
    assert aux.shape == () and abs(float(aux) - float(jaux)) <= 1e-6 and float(aux) > 0


def test_capacity_is_jax_s_formula():
    full = get_arch("olmoe-1b-7b").config.moe
    assert [L.moe_capacity(n, full) for n in (16384, 8192, 8)] == [2560, 1280, 8]
    for arch in ARCHS:
        for cfg in (get_arch(arch).config.moe, get_arch(arch).reduced.moe):
            for n in (1, 7, 8, 24, 48, 100, 1000, 8192):
                want = jround_up(max(8, int(n * cfg.top_k / cfg.num_experts
                                            * cfg.capacity_factor)), 8)
                assert L.moe_capacity(n, cfg) == want, (arch, n)


def test_slot_maps_are_each_others_inverse_and_rank_stably():
    """A routing where expert 1 takes more picks than its capacity: the
    earliest tokens keep their slots, in token order; every kept pick's
    slot maps back to it, every dropped one is -1, and a token's picks go
    in ascending expert order."""
    n, k, e, cap = 12, 2, 4, 8
    ids = torch.tensor([[1, 0]] * 10 + [[3, 1], [2, 3]])
    w = torch.rand(n, k, generator=torch.Generator().manual_seed(0))
    s = L.moe_slots(ids, w, e, cap)
    assert s.pick_slot.shape == (n, k) and s.slot_pick.shape == (e * cap,)
    assert torch.equal(s.pick_w, torch.cat([w[:11].flip(1), w[11:]]))
    # experts 0 and 1 each take tokens 0..9 (and expert 1 token 10 too):
    # tokens 0-7 keep their slots, in token order, the later ones drop
    for j, expert in enumerate((0, 1)):  # a token's picks ascending: (0, 1)
        assert s.pick_slot[:10, j].tolist() == [expert * cap + r for r in range(8)] + [-1, -1]
    assert s.pick_slot[10].tolist() == [-1, 3 * cap]  # expert 1 is full by token 10
    assert s.pick_slot[11].tolist() == [2 * cap, 3 * cap + 1]
    flat = s.pick_slot.reshape(-1)
    for pick, slot in enumerate(flat.tolist()):
        if slot >= 0:
            assert int(s.slot_pick[slot]) == pick
    assert int((s.slot_pick >= 0).sum()) == int((flat >= 0).sum()) == n * k - 5


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("form,capacity_factor", [
    ("slotted", None), ("slotted", 0.5), ("dense", None)])
def test_moe_forms_and_their_grads_match_jax(arch, form, capacity_factor):
    """Output, aux, and the gradients of sum(out * c) + aux, c a fixed
    numpy draw of std 1/4 (the gradients O(1): the router's sums 48
    tokens), with respect to x and every MoE weight. The slotted form
    at the config's capacity drops no pick, at 0.5 it drops some."""
    jcfg, jm, tm, p, x = _moe_pair(arch, capacity_factor)
    c = (np.random.default_rng(9).normal(size=x.shape) * 0.25).astype(np.float32)
    jfn = {"slotted": JL.apply_moe_slotted, "dense": JL.apply_moe_dense}[form]
    tfn = {"slotted": L.apply_moe_slotted, "dense": L.apply_moe_dense}[form]

    def jloss(params, xx):
        out, aux = jfn(params, xx, jm, jcfg.mlp_type, jcfg.activation)
        return jnp.sum(out * c) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tfn(tp, tx, tm, jcfg.mlp_type, jcfg.activation)
    grads = torch.autograd.grad((out * torch.from_numpy(c)).sum() + aux, [*tp.values(), tx])
    assert out.shape == x.shape and out.dtype == torch.float32
    assert _max_diff(out, jout) <= 1e-5 and abs(float(aux.detach()) - float(jaux)) <= 1e-5
    assert set(tp) == {"router", "wi", "wg", "wo"}
    for (name, _), g in zip(tp.items(), grads):
        assert _max_diff(g, jgp[name]) <= 1e-5, name
    assert _max_diff(grads[-1], jgx) <= 1e-5
    if form == "slotted":
        xt = torch.from_numpy(x.reshape(-1, jcfg.d_model))
        ids, w = L._topk_routing(xt @ torch.from_numpy(p["router"].copy()), tm.top_k)
        dropped = int((L.moe_slots(ids, w, tm.num_experts, L.moe_capacity(48, tm))
                       .pick_slot < 0).sum())
        assert (dropped > 0) == (capacity_factor is not None), dropped


def test_apply_moe_takes_the_slotted_form():
    jcfg, jm, tm, p, x = _moe_pair("grok-1-314b")  # JAX's dense case on a mesh
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    a = L.apply_moe(tp, torch.from_numpy(x), tm, jcfg.mlp_type, jcfg.activation)
    b = L.apply_moe_slotted(tp, torch.from_numpy(x), tm, jcfg.mlp_type, jcfg.activation)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    want, _ = JL.apply_moe(p, jnp.asarray(x), jm, jcfg.mlp_type, jcfg.activation, 1)
    assert _max_diff(a[0], want) <= 1e-5


# ---------------------------------------------------------------------------
# the whole LM: loss and gradients, prefill and decode
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_lm_params(arch, seed=0):
    """JAX's init of the reduced LM from ``PRNGKey(seed)``, as numpy: drawn
    once for the tests that share it (a JAX init compiles each draw)."""
    return jax.tree.map(np.asarray, JT.init_lm_params(jax.random.PRNGKey(seed),
                                                      jget_arch(arch).reduced))


def _loss_pair(arch, seed=0, top_k=None, **overrides):
    jcfg = dataclasses.replace(jget_arch(arch).reduced, **overrides)
    tcfg = dataclasses.replace(get_arch(arch).reduced, **overrides)
    if top_k is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, top_k=top_k))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, top_k=top_k))
    jp = _jax_lm_params(arch, seed)  # compute_dtype and top_k draw nothing
    rng = np.random.default_rng(seed + 7)
    emb = (rng.normal(size=(2, 16, jcfg.d_model)) * 0.5).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    labels[1, -2:] = -1
    jloss = JT.make_lm_loss_fn(jcfg, ParallelConfig(), None, t_chunk=8)
    (jtotal, jmet), (jg, jge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                           has_aux=True))(
        jp, jnp.asarray(emb), {"labels": jnp.asarray(labels)})
    tp = {k: v.requires_grad_() for k, v in lm_params_from_jax(jp).items()}
    temb = torch.from_numpy(emb).requires_grad_()
    total, met = TT.make_lm_loss_fn(tcfg, t_chunk=8)(tp, temb,
                                                     {"labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(total, [*tp.values(), temb])
    jgrads = lm_params_from_jax(jax.tree.map(np.asarray, jg))
    return (jtotal, jmet, jgrads, jge), (total, met, dict(zip(tp, grads[:-1])), grads[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax_value_and_grad(arch):
    (jtotal, jmet, jgrads, jge), (total, met, grads, ge) = _loss_pair(arch)
    assert float(met["moe_aux"]) > 0.5  # two layers' terms, each about 1
    assert abs(float(met["moe_aux"]) - float(jmet["moe_aux"])) <= 1e-6
    assert abs(float(total.detach()) - float(jtotal)) <= 1e-5
    assert abs(float(met["xent"]) - float(jmet["xent"])) <= 1e-5
    assert set(grads) == set(jgrads) and "blocks.0.moe.router" in grads
    for k, g in grads.items():
        assert g.shape == jgrads[k].shape, k
        assert _max_diff(g, jgrads[k]) <= 1e-5, k
    assert _max_diff(ge, jge) <= 1e-5


def test_bf16_compute_lm_loss_and_grads_match_jax():
    """Reduced olmoe with f32 params computing in bf16 (the router cast to
    bf16 and lifted back to f32 in both): the loss and each gradient within
    3% of its largest magnitude of JAX's.

    Every token is routed to all 8 experts here. A top-k choice is not
    continuous: the two packages round to bf16 at different places, and at
    top-2 one token of this batch's 32 routes to another expert in layer 0
    (its two logits within that rounding), which moves its hidden state by
    O(1). With every expert picked the function is continuous, and the
    dispatch, the capacity slots, the bf16 combine and the router's
    promotion all still run; the f32 cases above hold the top-k choice."""
    (jtotal, jmet, jgrads, jge), (total, met, grads, ge) = _loss_pair(
        ARCH, compute_dtype="bfloat16", top_k=8)
    assert abs(float(total.detach()) - float(jtotal)) <= BF16_RTOL * abs(float(jtotal))
    assert abs(float(met["moe_aux"]) - float(jmet["moe_aux"])) <= \
        BF16_RTOL * abs(float(jmet["moe_aux"]))
    for k, g in grads.items():
        assert g.dtype == torch.float32, k
        want = _f32(jgrads[k])
        assert _max_diff(_f32(g), want) <= BF16_RTOL * float(np.abs(want).max()), k
    assert _max_diff(_f32(ge), _f32(jge)) <= BF16_RTOL * float(np.abs(_f32(jge)).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """The prefill's logits and caches, then 3 decode steps (each routing
    the batch's 2 new tokens), within 1e-5."""
    jcfg, tcfg = jget_arch(arch).reduced, get_arch(arch).reduced
    jp = _jax_lm_params(arch)
    tp = lm_params_from_jax(jp)
    rng = np.random.default_rng(21)
    emb = rng.normal(size=(2, 8, jcfg.d_model)).astype(np.float32) * 0.5
    jl, jc = JT.lm_prefill(jp, jcfg, jnp.asarray(emb), cache_len=11)
    tl, tc = TT.lm_prefill(tp, tcfg, torch.from_numpy(emb), cache_len=11)
    assert _max_diff(tl, jl) <= 1e-5
    for n in "kv":
        assert _max_diff(tc.caches[0][n], jc.caches[0][n]) <= 1e-5
    for _ in range(3):
        e = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32) * 0.5
        jl, jc = JT.lm_decode_step(jp, jcfg, jnp.asarray(e), jc)
        tl, tc = TT.lm_decode_step(tp, tcfg, torch.from_numpy(e), tc)
        assert tl.shape == (2, jcfg.vocab_size) and _max_diff(tl, jl) <= 1e-5


# ---------------------------------------------------------------------------
# Session.train against JAX's; serving; convert
# ---------------------------------------------------------------------------


def _port_session(init_np, mode):
    sess = Session.from_arch(ARCH, mode=mode, device="cpu",
                             opt_cfg=OptimizerConfig(lr=LR, eps=ADAM_EPS), **KW)
    sess.state = train_state_from_jax(init_np, "cpu")
    return sess


@pytest.fixture(scope="module")
def moe_runs():
    """Per mode: JAX's initial state (one draw), JAX's session and run
    (nestpipe and serial), and the port's run from that state."""
    out, init = {}, None
    for mode in MODES:
        jsess = jrep = None
        if mode != "async":
            jsess = JSession.from_arch(ARCH, mode=mode, store="device",
                                       opt_cfg=JOptimizerConfig(lr=LR, eps=ADAM_EPS), **KW)
            init = jax.tree.map(_np, jsess.state) if init is None else init
            jrep = jsess.train(STEPS)
        rep = _port_session(init, mode).train(STEPS)
        out[mode] = (init, jsess, jrep, rep)
    return out


@pytest.mark.parametrize("mode", ["nestpipe", "serial"])
def test_moe_trajectory_matches_jax(moe_runs, mode):
    _, _, jrep, rep = moe_runs[mode]
    jstate = jax.tree.map(_np, jrep.state)
    assert rep.summary["arch"] == ARCH and rep.summary["overflow_max"] == 0
    np.testing.assert_allclose(rep.stats.losses, jrep.stats.losses, rtol=0, atol=1e-5)
    if mode == "nestpipe":  # the window's metrics carry the MoE term
        assert len(rep.stats.moe_aux) == STEPS and min(rep.stats.moe_aux) > 0
    jdense = lm_params_from_jax(jstate.dense)
    assert set(jdense) == set(rep.state.dense)
    for k, v in jdense.items():
        assert _max_diff(rep.state.dense[k], v) <= 1e-5, k
    assert _max_diff(rep.state.table.rows, jstate.table.rows) <= 1e-5
    assert _max_diff(rep.state.table.accum, jstate.table.accum) <= 1e-5


def _reference_run(init_np, clustering):
    """The port's reference trainer over STEPS steps of the session's stream,
    its micro-batches cut by ``clustering``."""
    sess = _port_session(init_np, "nestpipe")
    wl = sess.workload
    ref_step = build_reference_step(wl.bundle.loss_fn(wl.t_chunk), sess.optimizer,
                                    constant_lr(sess.opt_cfg.lr), wl.n_micro)
    transform = make_cluster_transform(wl.n_micro, clustering)
    stream = resolve_stream(wl, sess.seed)
    state = clone_state(train_state_from_jax(init_np, "cpu"))
    for _ in range(STEPS):
        batch = transform(next(stream))
        state, _ = ref_step(state, stage_to_device(
            {k: batch[k] for k in ("keys", "labels")}, torch.device("cpu")))
    return state


def _gap(a, b):
    return max([_max_diff(a.table.rows, b.table.rows),
                _max_diff(a.table.accum, b.table.accum)]
               + [_max_diff(a.dense[k], b.dense[k]) for k in a.dense])


def test_moe_nestpipe_equals_serial_equals_reference_async_diverges(moe_runs):
    """nestpipe and serial each equal the reference trainer on their own
    micro-batches within 1e-5, and async diverges from it. An MoE's
    capacity and load-balance term depend on which tokens share a
    micro-batch, and serial cuts its micro-batches without nestpipe's
    key-centric clustering, so the two modes run different functions: JAX's
    nestpipe and serial end apart too, as the port's do."""
    init = moe_runs["nestpipe"][0]
    clustered = _reference_run(init, "keycentric")
    plain = _reference_run(init, "none")
    nest, serial = moe_runs["nestpipe"][3].state, moe_runs["serial"][3].state
    assert _gap(nest, clustered) <= 1e-5 and _gap(serial, plain) <= 1e-5
    assert _max_diff(moe_runs["async"][3].state.table.rows, clustered.table.rows) > 1e-6
    jnest, jserial = (lm_params_from_jax(jax.tree.map(_np, moe_runs[m][2].state.dense))
                      for m in ("nestpipe", "serial"))
    assert max(_max_diff(jnest[k], jserial[k]) for k in jnest) > 1e-4
    assert max(_max_diff(nest.dense[k], serial.dense[k]) for k in jnest) > 1e-4


def test_session_serve_tokens_equal_jax():
    """Reduced olmoe, batch 2, prompt 8, gen 4, on JAX's own fresh init
    (params from ``PRNGKey(seed)``, table from ``PRNGKey(1)``)."""
    seed = 0
    jsess = JSession.from_arch(ARCH, reduced=True, seed=seed)
    jrep = jsess.serve(batch=2, prompt_len=8, gen=4)
    jcfg = jget_arch(ARCH).reduced
    jp = _jax_lm_params(ARCH, seed)
    jspec = jmake_spec(None, vocab_size=jcfg.vocab_size, dim=jcfg.d_model, num_shards=1)
    jtable = jinit_table(jax.random.PRNGKey(1), jspec, None, ("data",))
    sess = Session.from_arch(ARCH, reduced=True, seed=seed, device="cpu")
    sess.ingest(lm_params_from_jax(jp),
                table_from_jax(np.asarray(jtable.rows), np.asarray(jtable.accum), "cpu"))
    rep = sess.serve(batch=2, prompt_len=8, gen=4)
    np.testing.assert_array_equal(rep.tokens, jrep.tokens)


def test_convert_carries_moe_params():
    """A bf16 olmoe (JAX's init, 2 layers): every MoE leaf under the port's
    name, its shape, its dtype (the router f32) and its bits; the port's own
    init has the same names, shapes and dtypes."""
    cfg = dataclasses.replace(jget_arch(ARCH).reduced, param_dtype="bfloat16")
    jp = JT.init_lm_params(jax.random.PRNGKey(3), cfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    n, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    moe = {k: (tuple(v.shape), v.dtype) for k, v in tp.items() if ".moe." in k}
    assert moe == {"blocks.0.moe.router": ((n, d, e), torch.float32),
                   "blocks.0.moe.wi": ((n, e, d, f), torch.bfloat16),
                   "blocks.0.moe.wg": ((n, e, d, f), torch.bfloat16),
                   "blocks.0.moe.wo": ((n, e, f, d), torch.bfloat16)}
    for name in ("router", "wi", "wg", "wo"):
        want = np.asarray(jnp.asarray(jp["blocks"][0]["moe"][name], jnp.float32))
        np.testing.assert_array_equal(tp[f"blocks.0.moe.{name}"].float().numpy(), want)
    own = TT.init_lm_params(dataclasses.replace(get_arch(ARCH).reduced,
                                                param_dtype="bfloat16"),
                            device="cpu", generator=torch.Generator())
    assert {k: (tuple(x.shape), x.dtype) for k, x in own.items()} == \
        {k: (tuple(x.shape), x.dtype) for k, x in tp.items()}
