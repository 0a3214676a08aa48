"""The port's dense-LM training path against the JAX package on the CPU.

- the attention kernels the full-width LMs train through (the wgmma
  forward with its lse; the wgmma backward at hd 80, the general one at
  160), by type and head dim;
- ``vocab_parallel_xent`` (no mesh) against JAX's, with ``t_chunk`` dividing
  T and not, pad labels (-1) and ids outside the vocabulary, the loss and
  its gradients within 1e-6;
- ``lm_backbone`` and ``make_lm_loss_fn``'s loss with its gradients (every
  dense param and the embeddings) against ``jax.value_and_grad`` for the
  reduced stablelm-3b (MHA) and yi-34b (GQA) in f32, within 1e-5; and
  computing in bf16 (f32 params), within the bf16 tolerance of
  tests/test_torch_lm.py::test_bf16_compute_matches_jax: 3% of the
  largest magnitude of each (both packages round to bf16 at places that
  differ);
- 4-step ``Session.train`` trajectories against JAX's ``Session.train`` in
  nestpipe and serial (losses, dense params, the master's rows and adagrad
  state, within ``atol=1e-5``) from JAX's own initial state, carried over
  by ``convert.train_state_from_jax``, on the same stream, at AdamW eps
  1e-6 (tests/test_torch_train.py's HSTU comparisons do the same): at the
  default 1e-8, AdamW's first step divides weights' gradients of ~1e-8,
  whose last bits the two packages sum differently, by about their own
  size, and one wg element ends 4.9e-5 apart (the losses 5e-7, the rows
  1.1e-6; the gap does not grow after the first step); at 1e-6 the dense
  params stay within 5.1e-6. nestpipe = serial = the port's reference
  trainer, async diverges;
- the loss falling in every mode (tests/test_api_session.py's LM case);
- serving after training: the trained weights, the tokens JAX's session
  generates after its own training;
- the train CLI on an LM arch.

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
from repro.configs.base import ParallelConfig
from repro.configs.registry import get_arch as jget_arch
from repro.models import transformer as JT
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro_torch.api import Session, resolve_stream
from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax, train_state_from_jax
from repro_torch.core.consistency import build_reference_step
from repro_torch.data.pipeline import make_cluster_transform, stage_to_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as TT
from repro_torch.train import clone_state, constant_lr

ARCH = "stablelm-3b"  # reduced: 2 layers, d_model 64, 4 heads of 16, vocab 512, f32
KW = dict(reduced=True, global_batch=8, seq_len=16, n_micro=2, t_chunk=32)
LR, ADAM_EPS = 2e-3, 1e-6
STEPS = 4
MODES = ("nestpipe", "serial", "async")
BF16_RTOL = 0.03  # tests/test_torch_lm.py::test_bf16_compute_matches_jax


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
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ---------------------------------------------------------------------------
# the attention kernels an LM trains through, and the chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,bwd", [("stablelm-3b", "wgmma"), ("stablelm-12b", "wgmma"),
                                      ("nemotron-4-340b", "simple")])
def test_full_width_lm_attention_goes_to_the_wgmma_kernels_by_head_dim(arch, bwd):
    """bf16 at the full configs' head dims: the wgmma forward, with its lse
    too, at all three (80, 160, 192); the wgmma backward at 80
    (stablelm-3b's, LM training's main path) and 160 (stablelm-12b's and
    pixtral-12b's), the general one at 192. The choice is made from the
    type and head dim alone, so CPU tensors of those shapes name the
    kernels."""
    a = get_arch(arch).config.attention
    q = torch.zeros((1, 4, a.n_heads, a.head_dim), dtype=torch.bfloat16)
    k = torch.zeros((1, 4, a.n_kv_heads, a.head_dim), dtype=torch.bfloat16)
    assert a.head_dim in fa.WGMMA_HEAD_DIMS
    assert (a.head_dim in fa.WGMMA_BWD_HEAD_DIMS) == (bwd == "wgmma")
    assert (fa.variant(q, k, k), fa.lse_variant(q, k, k), fa.bwd_variant(q, k, k)) == \
        ("wgmma", "wgmma", bwd)


@pytest.mark.parametrize("t_chunk", [4, 5, 64])  # divides T = 12, does not, more than T
def test_xent_matches_jax(t_chunk):
    rng = np.random.default_rng(t_chunk)
    b, t, d, v = 2, 12, 16, 40
    hidden = rng.normal(size=(b, t, d)).astype(np.float32)
    head_w = (rng.normal(size=(d, v)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, size=(b, t)).astype(np.int32)
    labels[0, -3:] = -1  # padding
    labels[1, 2] = v + 3  # outside the vocabulary: counted, its logit taken as 0

    def jloss(h, w):
        return JT.vocab_parallel_xent(h, w, jnp.asarray(labels), None, t_chunk=t_chunk)

    want, (wgh, wgw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(hidden), jnp.asarray(head_w))
    h, w = (torch.from_numpy(x).requires_grad_() for x in (hidden, head_w))
    got = TT.vocab_parallel_xent(h, w, torch.from_numpy(labels), t_chunk=t_chunk)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    assert _max_diff(h.grad, wgh) <= 1e-6 and _max_diff(w.grad, wgw) <= 1e-6


# ---------------------------------------------------------------------------
# the backbone and the loss, with their gradients
# ---------------------------------------------------------------------------


def _loss_pair(arch, seed=0, **overrides):
    """JAX's and the port's loss and gradients (dense params, embeddings)
    on JAX's init, carried across, and one numpy batch."""
    jcfg = dataclasses.replace(jget_arch(arch).reduced, **overrides)
    tcfg = dataclasses.replace(get_arch(arch).reduced, **overrides)
    jp = JT.init_lm_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 7)
    emb = (rng.normal(size=(2, 16, jcfg.d_model)) * 0.5).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    labels[1, -2:] = -1
    jloss = JT.make_lm_loss_fn(jcfg, ParallelConfig(), None, t_chunk=8)
    (jtotal, jmet), (jg, jge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                           has_aux=True))(
        jp, jnp.asarray(emb), {"labels": jnp.asarray(labels)})
    tp = {k: v.requires_grad_() for k, v in lm_params_from_jax(
        jax.tree.map(np.asarray, jp)).items()}
    temb = torch.from_numpy(emb).requires_grad_()
    total, met = TT.make_lm_loss_fn(tcfg, t_chunk=8)(tp, temb,
                                                     {"labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(total, [*tp.values(), temb])
    jgrads = lm_params_from_jax(jax.tree.map(np.asarray, jg))
    return (jtotal, jmet, jgrads, jge), (total, met, dict(zip(tp, grads[:-1])), grads[-1])


@pytest.mark.parametrize("arch", ["stablelm-3b", "yi-34b"])  # MHA; GQA (7 q heads, 1 kv)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    (jtotal, jmet, jgrads, jge), (total, met, grads, ge) = _loss_pair(arch)
    assert abs(float(total) - float(jtotal)) <= 1e-5
    assert abs(float(met["xent"]) - float(jmet["xent"])) <= 1e-5
    assert float(met["moe_aux"]) == float(jmet["moe_aux"]) == 0.0
    assert not met["xent"].requires_grad
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        assert g.shape == jgrads[k].shape, k
        assert _max_diff(g, jgrads[k]) <= 1e-5, k
    assert _max_diff(ge, jge) <= 1e-5


def test_bf16_compute_loss_and_grads_match_jax():
    """Reduced stablelm-3b with f32 params computing in bf16: the loss, and
    each gradient, within 3% of its largest magnitude of JAX's."""
    (jtotal, _, jgrads, jge), (total, _, grads, ge) = _loss_pair(
        "stablelm-3b", compute_dtype="bfloat16")
    assert abs(float(total) - float(jtotal)) <= BF16_RTOL * abs(float(jtotal))
    for k, g in grads.items():
        assert g.dtype == torch.float32, k  # the f32 leaf's gradient
        want = _f32(jgrads[k])
        assert _max_diff(_f32(g), want) <= BF16_RTOL * float(np.abs(want).max()), k
    assert ge.dtype == torch.float32
    assert _max_diff(_f32(ge), _f32(jge)) <= BF16_RTOL * float(np.abs(_f32(jge)).max())


# ---------------------------------------------------------------------------
# Session.train against JAX's
# ---------------------------------------------------------------------------


def _port_session(init_np, mode):
    sess = Session.from_arch(ARCH, mode=mode, device="cpu",
                             opt_cfg=OptimizerConfig(lr=LR, eps=ADAM_EPS), **KW)
    sess.state = train_state_from_jax(init_np, "cpu")
    return sess


@pytest.fixture(scope="module")
def lm_runs():
    """Per mode: JAX's initial state (one draw: every mode's session draws
    it from the same seed), JAX's session and run (nestpipe and serial; the
    async run is only held against the port's reference), and the port's
    run from that state."""
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
def test_lm_trajectory_matches_jax(lm_runs, mode):
    _, _, jrep, rep = lm_runs[mode]
    jstate = jax.tree.map(_np, jrep.state)
    assert rep.summary["arch"] == ARCH and rep.summary["mode"] == mode
    assert rep.summary["overflow_max"] == 0
    assert rep.summary["tokens_per_s"] == rep.summary["samples_per_s"] * 16
    np.testing.assert_allclose(rep.stats.losses, jrep.stats.losses, rtol=0, atol=1e-5)
    jdense = lm_params_from_jax(jstate.dense)
    assert set(jdense) == set(rep.state.dense)
    for k, v in jdense.items():
        assert _max_diff(rep.state.dense[k], v) <= 1e-5, k
    assert _max_diff(rep.state.table.rows, jstate.table.rows) <= 1e-5
    assert _max_diff(rep.state.table.accum, jstate.table.accum) <= 1e-5
    assert int(rep.state.step) == int(jstate.step) == STEPS


def test_lm_nestpipe_equals_serial_equals_reference_async_diverges(lm_runs):
    init = train_state_from_jax(lm_runs["nestpipe"][0], "cpu")
    sess = _port_session(lm_runs["nestpipe"][0], "nestpipe")
    wl = sess.workload
    ref_step = build_reference_step(wl.bundle.loss_fn(wl.t_chunk), sess.optimizer,
                                    constant_lr(sess.opt_cfg.lr), wl.n_micro)
    transform = make_cluster_transform(wl.n_micro, wl.npcfg.clustering)
    stream = resolve_stream(wl, sess.seed)
    state = clone_state(init)
    for _ in range(STEPS):
        batch = transform(next(stream))
        assert batch["keys"].shape == batch["labels"].shape == (2, 4, 16)
        state, _ = ref_step(state, stage_to_device(
            {k: batch[k] for k in ("keys", "labels")}, torch.device("cpu")))

    def gap(a, b):
        return max([_max_diff(a.table.rows, b.table.rows),
                    _max_diff(a.table.accum, b.table.accum)]
                   + [_max_diff(a.dense[k], b.dense[k]) for k in a.dense])

    nest, serial = lm_runs["nestpipe"][3].state, lm_runs["serial"][3].state
    assert gap(nest, state) <= 1e-5 and gap(serial, state) <= 1e-5
    assert _max_diff(lm_runs["async"][3].state.table.rows, state.table.rows) > 1e-6


@pytest.mark.parametrize("mode", MODES)
def test_lm_loss_falls_in_every_mode(lm_runs, mode):
    """The port's 4 steps, then 4 more: the last quarter's mean loss below
    the first's (tests/test_api_session.py's LM criterion over 8 steps)."""
    _, _, _, rep = lm_runs[mode]
    sess = _port_session(lm_runs[mode][0], mode)
    sess.state = clone_state(rep.state)  # the run updates its master in place
    more = sess.train(STEPS)
    losses = list(rep.stats.losses) + list(more.stats.losses)
    assert np.isfinite(losses).all() and int(more.state.step) == 2 * STEPS
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses


def test_serve_after_train_equals_jax(lm_runs):
    """After the nestpipe run, both sessions serve their trained weights:
    the same tokens (JAX's ``test_lm_serve_after_train``, held to JAX's)."""
    init, jsess, _, _ = lm_runs["nestpipe"]
    sess = _port_session(init, "nestpipe")
    rep = sess.train(STEPS)
    params, table = sess.lm_weights()
    assert params is rep.state.dense and table is rep.state.table
    got = sess.serve(batch=2, prompt_len=8, gen=4)
    want = jsess.serve(batch=2, prompt_len=8, gen=4)
    assert got.tokens.shape == (2, 4) and got.summary["generated"] == 4
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_ingested_weights_train_with_fresh_moments():
    """An LM session that ``ingest`` handed weights serves them with no
    optimizer state, and its train state starts from them at step 0."""
    src = Session.from_arch(ARCH, device="cpu", seed=5, **KW)
    params, table = src.lm_weights()
    sess = Session.from_arch(ARCH, device="cpu", **KW)
    sess.ingest(params, table)
    assert sess._state is None  # serving holds no moments
    state = sess.state
    assert int(state.step) == 0 and int(state.opt.step) == 0
    assert all(torch.equal(state.dense[k], v) for k, v in params.items())
    assert all(float(m.abs().max()) == 0.0 for m in state.opt.mu.values())
    assert sess.lm_weights()[0] is state.dense


def test_lm_cli_trains_on_cpu(capsys):
    from repro_torch.launch.train import train

    state, stats = train(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--global-batch", "8", "--seq-len", "16", "--steps", "3"])
    assert len(stats.losses) == 3 and np.isfinite(stats.losses).all()
    assert int(state.step) == 3 and "blocks.0.attn.wq" in state.dense
    out = capsys.readouterr().out
    assert '"arch": "stablelm-3b"' in out and '"seq_len": 16' in out
    assert '"tokens_per_s"' in out


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_in_blocks_keeps_the_whole_leaf_s_bits(monkeypatch, grad_clip):
    """AdamW updates a leaf larger than ``ADAM_PIECE_ELEMS`` a block of rows
    at a time (an MoE expert leaf at full width is 805 M elements): with
    blocks of at most 100 elements (4 rows of 24, 6 rows of 15 in bf16; a
    leaf of one row longer than a block; a vector and a scalar within one)
    two steps' params, moments and norms equal the whole-leaf update's,
    bit for bit, f32 and bf16 leaves alike."""
    from repro_torch.train import optim

    rng = np.random.default_rng(3)
    shapes = {"stack": (9, 4, 6), "row": (1, 333), "vec": (50,), "scalar": (),
              "bf16": (7, 5, 3)}

    def draw(scale):
        out = {}
        for k, s in shapes.items():
            t = torch.from_numpy(np.asarray(rng.normal(size=s) * scale, dtype=np.float32))
            out[k] = t.to(torch.bfloat16) if k == "bf16" else t
        return out

    params, grads = draw(1.0), draw(3.0)
    opt = optim.make_adamw(OptimizerConfig(lr=1e-2, weight_decay=0.1, grad_clip=grad_clip))
    runs = []
    for piece in (1 << 40, 100):
        monkeypatch.setattr(optim, "ADAM_PIECE_ELEMS", piece)
        state = opt.init(params)
        for k in params:  # moments that are not zeros
            state.mu[k].copy_(grads[k].float() * 0.1)
            state.nu[k].copy_(grads[k].float().square() * 0.01)
        new, st, gnorm = opt.update(params, state, grads, torch.tensor(1e-2))
        new, st, gnorm = opt.update(new, st, grads, torch.tensor(1e-2))
        runs.append((new, st, gnorm))
    (a, sa, na), (b, sb, nb) = runs
    assert torch.equal(na, nb) and int(sa.step) == int(sb.step) == 2
    for k in params:
        assert a[k].dtype == params[k].dtype and torch.equal(a[k], b[k]), k
        assert torch.equal(sa.mu[k], sb.mu[k]) and torch.equal(sa.nu[k], sb.nu[k]), k
        assert not torch.equal(a[k], params[k]), k
