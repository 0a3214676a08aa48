"""The port's FuXi model, its attention's plain backward, and FuXi training
against the JAX package, on the CPU.

- the plain ``flash_attention_bwd_ref`` (the explicit formulas the CUDA
  backward computes) against ``jax.vjp`` of JAX's ``chunked_attention``
  (what FuXi's layers run) and of ``naive_attention``, and against torch
  autograd of ``flash_attention_ref``: f32, causal and full, H/KV in
  {1, 4} (the kv heads' gradients summed over their group), Tq = Tk and
  Tq 5 against Tk 9, within 1e-5 of each gradient's sum of magnitudes +
  1e-7 (``ref.flash_attention_bwd_bound``);
- ``flash_attention_lse_ref`` against a masked ``jax.nn.logsumexp``,
  within ``ref.flash_attention_lse_bound``;
- the port's FuXi layer against JAX's layer (JAX's own functions, composed
  as ``src/repro/models/fuxi.py``'s ``body_fn``), ``fuxi_forward`` and the
  loss with its dense and embedding gradients against
  ``jax.value_and_grad`` at ``fuxi-reduced``, weights carried across by
  ``fuxi_params_from_jax``, at ``tests/test_torch_hstu.py``'s tolerances
  (1e-5; a bf16 embedding gradient within one bf16 step);
- 6-step trajectories against the JAX ``Session`` in all three modes at
  ``fuxi-reduced`` (``global_batch=16``, N = 4), within ``atol=1e-5``
  (tests/test_consistency.py's tolerance), at the configuration's own
  step sizes: FuXi does not amplify rounding as HSTU does
  (``test_fuxi_default_step_sizes_do_not_amplify_rounding`` pins it);
  nestpipe == serial == the reference trainer, async diverges;
- the train CLI at ``--arch fuxi-kuairand --reduced --device cpu``, the
  session's default device, and serving's refusal.
"""
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
from repro.models import fuxi as jfuxi
from repro.models import layers as jlayers
from repro_torch.api import Session, resolve_stream
from repro_torch.configs.registry import get_arch
from repro_torch.convert import dense_params_from_jax, fuxi_params_from_jax, \
    train_state_from_jax
from repro_torch.core.consistency import build_reference_step
from repro_torch.data.pipeline import make_cluster_transform, stage_to_device
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.build import make_loss_fn
from repro_torch.models import FuXi, fuxi_forward, fuxi_layer, make_fuxi_loss_fn
from repro_torch.models.fuxi import attention_config
from repro_torch.train import clone_state, constant_lr

ARCH = "fuxi-kuairand"  # reduced: one 4,096 x 32 table, d_model 64, 2 layers, 4 heads, T 32
KW = dict(reduced=True, global_batch=16, n_micro=4)
STEPS = 6
MODES = ("nestpipe", "serial", "async")


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _attn_inputs(b, tq, tk, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, h, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, tk, kv, hd)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(b, tq, h, hd)).astype(np.float32)
    return q, k, v, do


def _repeat(x, h):
    return jnp.repeat(x, h // x.shape[2], axis=2)


def _assert_within(got, want, bounds, label):
    for name, g, w, bd in zip(("dq", "dk", "dv"), got, want, bounds):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (label, name, g.shape, w.shape)
        err = np.abs(g - w)
        assert (err <= bd.numpy()).all(), (label, name, float(err.max()))


ATTN_CASES = [(tq, tk, kv, causal) for tq, tk in ((12, 12), (5, 9))
              for kv in (4, 1) for causal in (True, False)]


@pytest.mark.parametrize("tq,tk,kv,causal", ATTN_CASES)
def test_plain_backward_matches_jax_vjp_and_autograd(tq, tk, kv, causal):
    """H = 4 query heads over ``kv`` kv heads (H/KV 1 or 4), hd 8."""
    h, hd = 4, 8
    q, k, v, do = _attn_inputs(2, tq, tk, h, kv, hd, seed=tq * 10 + kv)
    tq_, tk_, tv_, tdo = _t(q, k, v, do)
    o = ref.flash_attention_ref(tq_, tk_, tv_, causal)
    lse = ref.flash_attention_lse_ref(tq_, tk_, causal)
    got = ref.flash_attention_bwd_ref(tq_, tk_, tv_, o, tdo, lse, causal)
    bounds = ref.flash_attention_bwd_bound(tq_, tk_, tv_, o, tdo, lse, got, causal)

    def chunked(a, b_, c):
        return jlayers.chunked_attention(a, _repeat(b_, h), _repeat(c, h), causal=causal,
                                         q_chunk=4, kv_chunk=4)

    def naive(a, b_, c):
        return jlayers.naive_attention(a, _repeat(b_, h), _repeat(c, h), causal=causal)

    for fn in (chunked, naive):
        jo, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
        _assert_within(got, vjp(jnp.asarray(do)), bounds, fn.__name__)
    leaves = [x.clone().requires_grad_() for x in (tq_, tk_, tv_)]
    ref.flash_attention_ref(*leaves, causal).backward(tdo)
    _assert_within(got, [x.grad for x in leaves], bounds, "autograd")


@pytest.mark.parametrize("tq,tk,causal", [(12, 12, True), (5, 9, True), (5, 9, False)])
def test_lse_matches_masked_jax_logsumexp(tq, tk, causal):
    q, k, _, _ = _attn_inputs(2, tq, tk, 4, 1, 8, seed=3)
    got = ref.flash_attention_lse_ref(*_t(q, k), causal)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), _repeat(jnp.asarray(k), 4)) * 8 ** -0.5
    if causal:
        s = jnp.where(jnp.arange(tq)[:, None] >= jnp.arange(tk)[None, :], s, -1e30)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    assert got.shape == (2, 4, tq) and got.dtype == torch.float32
    bound = ref.flash_attention_lse_bound(*_t(q, k), got, causal).numpy()
    assert (np.abs(got.numpy() - want) <= bound).all()


def test_cpu_attention_grad_launches_nothing_and_kernels_refuse_cpu():
    q, k, v, do = _t(*_attn_inputs(1, 8, 8, 2, 1, 4, seed=1))
    before = (fa.launches, fa.launches_bwd)
    q.requires_grad_()
    dispatch.flash_attention(q, k, v).backward(do)
    assert (fa.launches, fa.launches_bwd) == before and q.grad is not None
    lse = ref.flash_attention_lse_ref(q.detach(), k)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q.detach(), k, v, do, do, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_lse(q.detach(), k, v)


def _jax_params(cfg, seed=0):
    params = jfuxi.init_fuxi_params(jax.random.PRNGKey(seed), cfg)
    # non-trivial norms, so a swapped scale shows
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + rng.normal(size=x.shape).astype(np.float32)
                              * 0.1), params)


def _port_params(jparams):
    return fuxi_params_from_jax(jax.tree.map(np.asarray, jparams))


def _jax_layer(lp, x, cfg):
    """JAX's FuXi layer, composed from JAX's own functions as
    ``src/repro/models/fuxi.py``'s ``body_fn`` composes them."""
    acfg = jfuxi._attn_cfg(cfg)
    b, s, _ = x.shape
    positions = jnp.broadcast_to(jnp.arange(s), (b, s))
    h = jlayers.apply_norm(lp["norm1"], x, cfg.norm_eps)
    x = x + jlayers.gqa_attention(lp["attn"], h, acfg, positions=positions)
    h = jlayers.apply_norm(lp["norm2"], x, cfg.norm_eps)
    v = h @ lp["w_up"]
    base = v
    for o in range(jfuxi._FI_ORDERS):
        v = v * jax.nn.sigmoid(base @ lp[f"w_fi{o}"]) + v
    return x + v @ lp["w_down"]


@pytest.mark.parametrize("s", [32, 40])
def test_layer_matches_jax_layer_on_converted_weights(s):
    """Within 1e-5 plus 1e-6 of each value: on unit inputs the three
    interaction orders (each up to doubling v) carry the layer's output to
    about 12, where f32 products added in another order differ by a few
    ulps (1.3e-5 at 12.0 seen, 1.1e-6 of it)."""
    jcfg = jget_arch(ARCH).reduced
    cfg = get_arch(ARCH).reduced  # d 64, 4 heads of 16
    jparams = _jax_params(jcfg)
    params = _port_params(jparams)
    x = np.random.default_rng(3).normal(size=(2, s, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[1], jparams["layers"])  # the second layer
    want = _jax_layer(lp, jnp.asarray(x), jcfg)
    got = fuxi_layer(params, "layers.1", torch.from_numpy(x), attention_config(cfg),
                     cfg.norm_eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def _emb(cfg, b, dtype=np.float32, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, cfg.seq_len, cfg.max_table_dim)) * 0.1).astype(dtype)


def test_forward_matches_jax():
    jcfg, cfg = jget_arch(ARCH).reduced, get_arch(ARCH).reduced
    jparams = _jax_params(jcfg, seed=2)
    emb = _emb(cfg, 3)
    want = jfuxi.fuxi_forward(jparams, jcfg, jnp.asarray(emb))
    got = fuxi_forward(_port_params(jparams), cfg, torch.from_numpy(emb))
    assert got.shape == (3, cfg.seq_len, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax_value_and_grad(dtype):
    """Loss, metric, dense and embedding gradients at ``fuxi-reduced``. With
    bf16 lookups the forward lifts them to f32 and the embedding gradient
    comes back in bf16: in both packages it is the bf16 sum of two
    gradients each rounded to bf16 (the input side and the target side),
    and an f32 gradient that differs in its last bits may round to the
    neighbouring bf16 value at each of those roundings. It is held within
    two bf16 steps (2**-6 of the value; 2 steps at 0.080 seen) plus 1e-5,
    and over 95% of it equal."""
    jcfg, cfg = jget_arch(ARCH).reduced, get_arch(ARCH).reduced
    jparams = _jax_params(jcfg, seed=3)
    params = {k: v.requires_grad_() for k, v in _port_params(jparams).items()}
    emb32 = _emb(cfg, 2, seed=9)
    jemb = jnp.asarray(emb32, dtype=jnp.dtype(dtype))
    emb = torch.from_numpy(emb32).to(getattr(torch, dtype)).requires_grad_()

    jloss_fn = jfuxi.make_fuxi_loss_fn(jcfg, None, None)
    (jl, jm), (jg, jge) = jax.value_and_grad(jloss_fn, argnums=(0, 1), has_aux=True)(
        jparams, jemb, {})
    loss, metrics = make_fuxi_loss_fn(cfg)(params, emb, {})
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    assert float(metrics["hitrate_inseq"]) == float(jm["hitrate_inseq"])
    want = fuxi_params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(want) == set(params)
    for k, w in want.items():
        np.testing.assert_allclose(params[k].grad.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert emb.grad.dtype == emb.dtype
    ge, wge = emb.grad.to(torch.float32).numpy(), np.asarray(jge, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(ge, wge, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(ge, wge, rtol=2.0 ** -6, atol=1e-5)
        assert np.mean(ge == wge) > 0.95


def test_stacked_params_convert_to_the_module_state_dict():
    jcfg, cfg = jget_arch(ARCH).reduced, get_arch(ARCH).reduced
    jparams = _jax_params(jcfg, seed=6)
    params = _port_params(jparams)
    model = FuXi(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert set(params) == set(sd)
    for k, v in sd.items():
        assert params[k].shape == v.shape and params[k].dtype == v.dtype, k
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(params[f"layers.{i}.attn.wq"].numpy(),
                                      np.asarray(jparams["layers"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(params[f"layers.{i}.w_fi2"].numpy(),
                                      np.asarray(jparams["layers"]["w_fi2"][i]))
        np.testing.assert_array_equal(params[f"layers.{i}.norm2.scale"].numpy(),
                                      np.asarray(jparams["layers"]["norm2"]["scale"][i]))
    model.load_state_dict(params)  # loads with strict name and shape checks
    emb = torch.from_numpy(_emb(cfg, 1))
    torch.testing.assert_close(model(emb), fuxi_forward(params, cfg, emb), rtol=0, atol=0)
    # the dense conversion tells the backbones apart by their layer keys
    got = dense_params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(got) == set(params) and all(torch.equal(got[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="layer keys"):
        dense_params_from_jax({"layers": {"w_other": np.zeros((1, 2))}})


def _np(x):
    return np.array(x, copy=True)  # the JAX run donates its input buffers


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _port_session(init_np, mode):
    sess = Session.from_arch(ARCH, mode=mode, device="cpu", **KW)
    sess.state = train_state_from_jax(init_np, "cpu")
    return sess


@pytest.fixture(scope="module")
def fuxi_runs():
    """Per mode: the JAX session's initial state and run, and the port's run
    from that state."""
    out = {}
    for mode in MODES:
        sess = JSession.from_arch(ARCH, mode=mode, store="device", **KW)
        init = jax.tree.map(_np, sess.state)
        jrep = sess.train(STEPS)
        rep = _port_session(init, mode).train(STEPS)
        out[mode] = (init, jrep.stats.losses, jax.tree.map(_np, jrep.state), rep)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_fuxi_trajectory_matches_jax(fuxi_runs, mode):
    _, jlosses, jstate, rep = fuxi_runs[mode]
    assert rep.summary["arch"] == ARCH and rep.summary["mode"] == mode
    assert rep.summary["overflow_max"] == 0
    np.testing.assert_allclose(rep.stats.losses, jlosses, rtol=0, atol=1e-5)
    jdense = dense_params_from_jax(jstate.dense)
    assert set(jdense) == set(rep.state.dense)
    for k, v in jdense.items():
        assert _max_diff(rep.state.dense[k], v) <= 1e-5, k
    assert _max_diff(rep.state.table.rows, jstate.table.rows) <= 1e-5
    assert _max_diff(rep.state.table.accum, jstate.table.accum) <= 1e-5
    assert int(rep.state.step) == int(jstate.step) == STEPS
    assert int(rep.state.opt.step) == int(jstate.opt.step) == STEPS


def _gap(a, b):
    return max([_max_diff(a.table.rows, b.table.rows),
                _max_diff(a.table.accum, b.table.accum)]
               + [_max_diff(a.dense[k], b.dense[k]) for k in a.dense])


def test_fuxi_nestpipe_equals_serial_equals_reference_async_diverges(fuxi_runs):
    init = train_state_from_jax(fuxi_runs["nestpipe"][0], "cpu")
    sess = _port_session(fuxi_runs["nestpipe"][0], "nestpipe")
    wl = sess.workload
    ref_step = build_reference_step(make_loss_fn(wl.cfg), sess.optimizer,
                                    constant_lr(sess.opt_cfg.lr), wl.n_micro)
    transform = make_cluster_transform(wl.n_micro, wl.npcfg.clustering)
    stream = resolve_stream(wl, sess.seed)
    state = clone_state(init)
    for _ in range(STEPS):
        batch = transform(next(stream))
        assert batch["keys"].shape == (4, 4, wl.cfg.seq_len)
        state, _ = ref_step(state, stage_to_device({"keys": batch["keys"]},
                                                   torch.device("cpu")))
    nest, serial = fuxi_runs["nestpipe"][3].state, fuxi_runs["serial"][3].state
    assert _gap(nest, state) <= 1e-5
    assert _gap(serial, state) <= 1e-5
    assert _gap(nest, serial) <= 1e-5
    assert _max_diff(fuxi_runs["async"][3].state.table.rows, state.table.rows) > 1e-6


def test_fuxi_default_step_sizes_do_not_amplify_rounding(capsys):
    """Why FuXi's trajectories are compared at the configuration's own step
    sizes, where HSTU's are not: from one state, the port's serial run
    stays within 1e-5 of JAX's in master rows and dense params at every
    one of 6 steps, and the gap does not grow tenfold from the first step
    to the last (HSTU's grows past 1e-5 from under 1e-6). Prints the
    gaps."""
    sess = JSession.from_arch(ARCH, mode="serial", store="device", **KW)
    port = _port_session(jax.tree.map(_np, sess.state), "serial")
    rows, dense = [], []
    for _ in range(STEPS):  # serial restarts exactly: one step at a time
        sess.train(1)
        port.train(1)
        rows.append(_max_diff(port.state.table.rows, _np(sess.state.table.rows)))
        jd = dense_params_from_jax(jax.tree.map(_np, sess.state.dense))
        dense.append(max(_max_diff(port.state.dense[k], jd[k]) for k in jd))
    with capsys.disabled():
        print(f"\nfuxi-reduced, default step sizes: port serial vs JAX serial per step, "
              f"rows {[f'{g:.3g}' for g in rows]}, dense {[f'{g:.3g}' for g in dense]}")
    assert max(rows) <= 1e-5 and max(dense) <= 1e-5
    assert rows[-1] <= 10 * max(rows[0], 1e-7)


def test_fuxi_cli_trains_on_cpu(capsys):
    from repro_torch.launch.train import train

    state, stats = train(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--global-batch", "16", "--steps", "3"])
    assert len(stats.losses) == 3 and np.isfinite(stats.losses).all()
    assert int(state.step) == 3 and "layers.1.w_fi2" in state.dense
    out = capsys.readouterr().out
    assert '"arch": "fuxi-kuairand"' in out and '"overflow_max": 0' in out


def test_default_device_is_cuda_and_serving_refuses_fuxi(monkeypatch):
    sess = Session.from_arch(ARCH, device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="DLRM head"):
        sess.serve_embeddings(num_requests=4, max_batch=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session.from_arch(ARCH, global_batch=256, bucket_slack=1.5)
