"""The training slice as a whole: the port against the JAX package.

The JAX ``Session``'s initial train state at the reduced ``dlrm-ctr``
(``global_batch=32``, N = 4, ``bucket_slack=4.0``) is taken before it
trains, carried into the port (``repro_torch.convert.train_state_from_jax``)
and both packages train 6 steps on the same synthetic stream, in each of
the modes ``nestpipe``, ``serial`` and ``async``:

- per-step losses, final dense params, master rows and adagrad state agree
  within ``atol=1e-5``, the tolerance of tests/test_consistency.py: f32
  matmuls add in another order on XLA:CPU than in torch;
- in the port, nestpipe == serial == the naive reference trainer
  (``core/consistency.py``) within ``1e-5``, and async diverges from it;
- at lookahead depth ``prefetch_ahead=2`` the same holds against the JAX
  session at that depth;
- the clustered host batches are byte-equal to JAX's;
- serving after training returns the trained weights (``exact == 1``);
- the CLI trains on the CPU.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.api import Session as JSession
from repro.data.pipeline import make_cluster_transform as jcluster
from repro_torch.api import Session, resolve_stream
from repro_torch.convert import dlrm_params_from_jax, train_state_from_jax
from repro_torch.core.consistency import build_reference_step
from repro_torch.data.pipeline import make_cluster_transform, stage_to_device
from repro_torch.kernels import buffer_sync as bs
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import segment_rowsum as sr
from repro_torch.models.dlrm import make_dlrm_loss_fn
from repro_torch.train import clone_state, constant_lr

ARCH = "dlrm-ctr"  # reduced: 3 tables, 5 feature slots, dim 16
KW = dict(reduced=True, global_batch=32, n_micro=4)
STEPS = 6
MODES = ("nestpipe", "serial", "async")


def _np(x):
    return np.array(x, copy=True)  # the JAX run donates its input buffers


@pytest.fixture(scope="module")
def jax_runs():
    """Per mode: the JAX session's initial state (numpy) and its run."""
    out = {}
    for mode in MODES:
        sess = JSession.from_arch(ARCH, mode=mode, store="device", **KW)
        init = jax.tree.map(_np, sess.state)
        rep = sess.train(STEPS)
        out[mode] = (init, rep.stats.losses, jax.tree.map(_np, rep.state))
    return out


def _port_session(init_np, mode, **kw):
    sess = Session.from_arch(ARCH, mode=mode, device="cpu", **KW, **kw)
    sess.state = train_state_from_jax(init_np, "cpu")
    return sess


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    out = {}
    for mode in MODES:
        rep = _port_session(jax_runs[mode][0], mode).train(STEPS)
        out[mode] = rep
    return out


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@pytest.mark.parametrize("mode", MODES)
def test_trajectory_matches_jax(jax_runs, port_runs, mode):
    _, jlosses, jstate = jax_runs[mode]
    rep = port_runs[mode]
    assert rep.summary["steps"] == STEPS and rep.summary["mode"] == mode
    assert len(rep.stats.losses) == STEPS
    np.testing.assert_allclose(rep.stats.losses, jlosses, rtol=0, atol=1e-5)
    jdense = dlrm_params_from_jax(jstate.dense)
    assert set(jdense) == set(rep.state.dense)
    for k, v in jdense.items():
        assert _max_diff(rep.state.dense[k], v) <= 1e-5, k
    assert _max_diff(rep.state.table.rows, jstate.table.rows) <= 1e-5
    assert _max_diff(rep.state.table.accum, jstate.table.accum) <= 1e-5
    assert int(rep.state.step) == int(jstate.step) == STEPS
    assert int(rep.state.opt.step) == int(jstate.opt.step) == STEPS
    if mode != "serial":
        assert rep.summary["overflow_max"] == 0


def _gap(a, b):
    return max([_max_diff(a.table.rows, b.table.rows),
                _max_diff(a.table.accum, b.table.accum)]
               + [_max_diff(a.dense[k], b.dense[k]) for k in a.dense])


@pytest.fixture(scope="module")
def reference_state(jax_runs):
    """The naive reference trainer's state after STEPS steps from the
    shared initial state, on the same clustered stream."""
    init = train_state_from_jax(jax_runs["nestpipe"][0], "cpu")
    sess = Session.from_arch(ARCH, device="cpu", **KW)
    wl = sess.workload
    ref_step = build_reference_step(make_dlrm_loss_fn(wl.cfg), sess.optimizer,
                                    constant_lr(sess.opt_cfg.lr), wl.n_micro)
    transform = make_cluster_transform(wl.n_micro, wl.npcfg.clustering)
    stream = resolve_stream(wl, sess.seed)
    state = clone_state(init)
    for _ in range(STEPS):
        batch = transform(next(stream))
        batch = stage_to_device({k: v for k, v in batch.items() if k != "raw_keys"},
                                torch.device("cpu"))
        state, _ = ref_step(state, batch)
    return state


def test_nestpipe_equals_serial_equals_reference_async_diverges(port_runs,
                                                                reference_state):
    nest, serial = port_runs["nestpipe"].state, port_runs["serial"].state
    assert _gap(nest, reference_state) <= 1e-5
    assert _gap(serial, reference_state) <= 1e-5
    assert _gap(nest, serial) <= 1e-5
    assert _max_diff(port_runs["async"].state.table.rows,
                     reference_state.table.rows) > 1e-6


@pytest.mark.parametrize("mode", ("nestpipe", "async"))
def test_prefetch_ahead_2_matches_jax(mode, reference_state):
    """Lookahead depth k = 2: two retrieved buffers are in flight, and
    nestpipe repairs both at every commit (``Prefetcher.resync``); the
    trajectory matches the JAX session at the same depth within 1e-5, and
    nestpipe still equals the reference trainer while async diverges."""
    jsess = JSession.from_arch(ARCH, mode=mode, store="device", prefetch_ahead=2,
                               **KW)
    init = jax.tree.map(_np, jsess.state)
    jrep = jsess.train(STEPS)
    jstate = jax.tree.map(_np, jrep.state)
    rep = _port_session(init, mode, prefetch_ahead=2).train(STEPS)
    assert rep.summary["overflow_max"] == 0
    np.testing.assert_allclose(rep.stats.losses, jrep.stats.losses, rtol=0, atol=1e-5)
    jdense = dlrm_params_from_jax(jstate.dense)
    for k, v in jdense.items():
        assert _max_diff(rep.state.dense[k], v) <= 1e-5, k
    assert _max_diff(rep.state.table.rows, jstate.table.rows) <= 1e-5
    assert _max_diff(rep.state.table.accum, jstate.table.accum) <= 1e-5
    if mode == "nestpipe":
        assert _gap(rep.state, reference_state) <= 1e-5
    else:
        assert _max_diff(rep.state.table.rows, reference_state.table.rows) > 1e-6


def test_clustered_host_batches_byte_equal_jax():
    sess = Session.from_arch(ARCH, device="cpu", **KW)
    jsess = JSession.from_arch(ARCH, store="device", **KW)
    from repro.api.streams import resolve_stream as jresolve

    for clustering in ("keycentric", "none"):
        ours = make_cluster_transform(4, clustering)
        theirs = jcluster(4, clustering)
        s_t, s_j = resolve_stream(sess.workload, 5), jresolve(jsess.workload, 5)
        for _ in range(3):
            bt, bj = ours(next(s_t)), theirs(next(s_j))
            assert set(bt) == set(bj)
            for k in bt:
                assert bt[k].dtype == bj[k].dtype and bt[k].shape == bj[k].shape
                assert bt[k].tobytes() == bj[k].tobytes(), (clustering, k)


def test_serving_after_training_serves_the_trained_weights(jax_runs):
    sess = _port_session(jax_runs["nestpipe"][0], "nestpipe")
    before = sess.serve_embeddings(num_requests=16, max_batch=8)
    init_rows = sess.state.table.rows.clone()
    counts = (eg.launches, sr.launches, bs.launches)
    sess.train(3)
    assert (eg.launches, sr.launches, bs.launches) == counts  # CPU: plain versions
    model, table = sess.weights()
    assert table.rows is sess.state.table.rows
    assert not torch.equal(table.rows, init_rows)
    for k, v in sess.state.dense.items():
        assert torch.equal(model.state_dict()[k], v)
    after = sess.serve_embeddings(num_requests=16, max_batch=8, check_exact=True)
    assert after.summary["exact"] == 1 and after.summary["max_abs_diff"] == 0.0
    assert not np.array_equal(after.results, before.results)
    logits = sess.serve_embeddings(num_requests=16, max_batch=8, head="dlrm",
                                   check_exact=True)
    assert logits.summary["exact"] == 1 and np.isfinite(logits.results).all()


def test_ingest_resets_the_optimizer_state(jax_runs):
    sess = _port_session(jax_runs["nestpipe"][0], "nestpipe")
    sess.train(2)
    assert int(sess.state.opt.step) == 2 and int(sess.state.step) == 2
    _, table = sess.weights()
    sess.ingest(sess.state.dense, table)
    assert int(sess.state.step) == 0 and int(sess.state.opt.step) == 0
    assert not any(m.any() for m in sess.state.opt.mu.values())


def test_unknown_mode_fails_fast_and_serve_does_not_train():
    with pytest.raises(KeyError, match="registered"):
        Session.from_arch(ARCH, mode="bogus", device="cpu", **KW)
    with pytest.raises(ValueError, match="inference-only"):
        Session.from_arch(ARCH, mode="serve", device="cpu", **KW).train(1)


def test_cli_trains_on_cpu(capsys):
    from repro_torch.launch.train import train

    state, stats = train(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--steps", "3", "--global-batch", "32"])
    assert len(stats.losses) == 3 and np.isfinite(stats.losses).all()
    assert int(state.step) == 3
    assert '"mode": "nestpipe"' in capsys.readouterr().out


@pytest.mark.parametrize("name,clip", [("adamw", 1.0), ("adamw", 0.0),
                                       ("sgd", 0.5)])
def test_dense_optimizers_match_jax(name, clip):
    """Three updates of ``make_optimizer`` on the same params and grads:
    within 1e-6 of JAX's (reductions and pow round differently)."""
    import jax.numpy as jnp
    from repro.configs.base import OptimizerConfig as JCfg
    from repro.train.optim import make_optimizer as jmake
    from repro_torch.configs.base import OptimizerConfig as TCfg
    from repro_torch.train import make_optimizer as tmake

    rng = np.random.default_rng(3)
    shapes = {"bottom.0.w": (5, 7), "bottom.0.b": (7,), "top.0.w": (7, 1)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 3 for k, s in shapes.items()}
             for _ in range(3)]
    kw = dict(name=name, lr=0.01, grad_clip=clip, weight_decay=0.01)
    jopt, topt = jmake(JCfg(**kw)), tmake(TCfg(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    lr = 0.01
    for g in grads:
        jp, js, jn = jopt.update(jp, js, {k: jnp.asarray(v) for k, v in g.items()},
                                 jnp.float32(lr))
        tp, ts, tn = topt.update(tp, ts, {k: torch.from_numpy(v) for k, v in g.items()},
                                 torch.tensor(lr))
        assert abs(float(jn) - float(tn)) <= 1e-5 * float(jn)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    assert int(ts.step) == int(js.step) == 3
