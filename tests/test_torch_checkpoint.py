"""Checkpoints in the port (``repro_torch.dist.checkpoint``,
``Session.save`` / ``restore`` / ``restore_if_available``, the driver's
checkpoint seam, ``convert.train_state_from_jax_checkpoint``, the train
CLI's ``--ckpt-dir`` / ``--ckpt-every`` / ``--resume``), against the JAX
package's checkpoints and against the port's own uninterrupted runs
(``tests/test_dist.py``, ``tests/test_api_session.py``,
``tests/test_store.py`` and ``tests/test_async_exec.py`` mirrored).

Workload: the reduced ``dlrm-ctr`` (``global_batch=32``, N = 4,
``bucket_slack=4.0``) on the CPU; ``hstu-reduced`` and ``fuxi-reduced`` in
their init state's structure only, for reading JAX checkpoints.

- Layout (bit for bit): JAX's directory and file names and manifest keys;
  the chunked writer's leaf files equal ``np.save``'s bytes across chunk
  boundaries; JAX's ``latest_step`` finds the port's step.
- JAX -> port: a JAX nestpipe run's step-3 checkpoint, read by
  ``train_state_from_jax_checkpoint`` and trained 3 steps in the port, lies
  within 1e-5 of the JAX run's step-6 checkpoint (losses, rows, adagrad
  state, dense params, AdamW moments; f32 matmuls add in another order on
  XLA:CPU than in torch, as ``tests/test_torch_train.py`` says). Reading a
  JAX checkpoint equals ``train_state_from_jax`` of the same leaves bit for
  bit, for DLRM, HSTU and FuXi (the stacked layers unstacked).
- The driver's seam: saving leaves a run as it was, bit for bit, and a
  slow save is no step's time (no straggler after it).
- Port -> port, bit for bit (``==`` on losses, ``torch.equal`` on every
  tensor): save mid-run, restore into a fresh session (another init seed,
  the same data seed), train on: the stitched run equals the uninterrupted
  one, on the device, host and cached tiers, with async stages off and on,
  from the cached tier into the device tier, and in serial mode; the
  exports a driver hands its checkpoint callback equal the synchronous
  ones under async stages; the CLI's resumed run equals its uninterrupted
  one.
- Integrity and misuse: damaged leaves raise naming CRC32 and
  ``restore_latest_verifiable`` falls back; structure mismatches raise; a
  failed restore leaves the state as it was (bit for bit); the store's
  placeholder is refused unless ``store=`` exports it.
"""
import io
import json
import os
import shutil
import sys
import time

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.api import Session as JSession
from repro.dist.checkpoint import latest_step as jlatest_step
from repro.dist.checkpoint import restore_checkpoint as jrestore_checkpoint
from repro.dist.checkpoint import save_checkpoint as jsave_checkpoint
from repro_torch.api import Session, resolve_stream
from repro_torch.convert import train_state_from_jax, train_state_from_jax_checkpoint
from repro_torch.core.store import HostStore, placeholder_table
from repro_torch.dist import checkpoint as ck
from repro_torch.dist import latest_step, restore_checkpoint, \
    restore_latest_verifiable, save_checkpoint
from repro_torch.train import clone_state

ARCH = "dlrm-ctr"  # reduced: 3 tables, 5 feature slots, dim 16
KW = dict(reduced=True, global_batch=32, n_micro=4)
STEPS, SAVE_AT = 5, 3


@pytest.fixture(autouse=True)
def _no_tier_env(monkeypatch):
    for var in ("REPRO_STORE", "REPRO_CACHE_POLICY", "REPRO_SPARSE_COMM",
                "REPRO_ASYNC_STAGES"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """These runs are many small ops: under the suite's workers, more
    intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _session(**kw):
    return Session.from_arch(ARCH, device="cpu", **KW, **kw)


def _np(x):
    return np.array(x, copy=True)  # the JAX run donates its input buffers


def _leaves(state):
    return ck.flatten_state(state)


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def _max_gap(a, b):
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))


# ---------------------------------------------------------------------------
# (a) layout
# ---------------------------------------------------------------------------


def test_layout_is_jax_s(tmp_path):
    """Directory name, manifest keys, file names and leaf paths, bit for
    bit; JAX's latest_step finds the port's step."""
    sess = _session(ckpt_dir=str(tmp_path))
    path = sess.save(step=3)
    assert os.path.basename(path) == "step_00000003"
    assert sorted(os.listdir(tmp_path)) == ["step_00000003"]  # no temp dir left
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    assert sorted(manifest) == ["leaves", "step"] and manifest["step"] == 3
    leaves = manifest["leaves"]
    files = sorted(os.listdir(path))
    assert files == sorted([f"leaf_{i:05d}.npy" for i in range(len(leaves))]
                           + ["manifest.json"])
    for i, e in enumerate(leaves):
        assert sorted(e) == ["crc32", "dtype", "file", "path", "shape"]
        assert e["file"] == f"leaf_{i:05d}.npy"
    paths = [e["path"] for e in leaves]
    dense = sorted(sess.state.dense)
    assert paths == ([f".dense[{k!r}]" for k in dense] + [".opt.step"]
                     + [f".opt.mu[{k!r}]" for k in dense]
                     + [f".opt.nu[{k!r}]" for k in dense]
                     + [".table.rows", ".table.accum", ".step"])
    assert paths[0] == ".dense['bottom.0.b']"
    assert jlatest_step(str(tmp_path)) == latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("chunk", [1000, 1001, 1 << 20])
def test_leaf_files_equal_np_save_bytes(tmp_path, monkeypatch, chunk):
    """Every leaf file of a saved state, and odd shapes and dtypes, equal
    np.save's bytes, whether a leaf spans many chunks or one; the CRC32 is
    that of the whole file. Bit for bit."""
    import zlib

    monkeypatch.setattr(ck, "CHUNK_BYTES", chunk)
    sess = _session(ckpt_dir=str(tmp_path))
    state = sess.state
    path = sess.save(step=0)
    rng = np.random.default_rng(0)
    extra = {"odd": torch.from_numpy(rng.standard_normal((37, 13)).astype(np.float32)),
             "scalar": torch.tensor(7, dtype=torch.int32),
             "empty": torch.zeros((0, 4)),
             "long": torch.from_numpy(rng.integers(-9, 9, 1001)),
             "mask": torch.from_numpy(rng.random(611) < 0.5),
             "f64": torch.from_numpy(rng.standard_normal(300))}
    extra_path = save_checkpoint(str(tmp_path / "extra"), {"x": extra}, 1)
    for d, tree in ((path, state), (extra_path, {"x": extra})):
        manifest = json.loads(open(os.path.join(d, "manifest.json")).read())
        for e, (_, t) in zip(manifest["leaves"], _leaves(tree)):
            buf = io.BytesIO()
            np.save(buf, t.numpy())
            raw = open(os.path.join(d, e["file"]), "rb").read()
            assert raw == buf.getvalue(), e["path"]
            assert e["crc32"] == zlib.crc32(raw)
    back = restore_checkpoint(str(tmp_path / "extra"),
                              {"x": {k: torch.zeros_like(v) for k, v in extra.items()}})
    _assert_same_state(back, {"x": extra})


# ---------------------------------------------------------------------------
# (b) JAX -> port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_dlrm_run(tmp_path_factory):
    """A JAX nestpipe run of 6 steps saving every 3: (dir, losses, final
    state as numpy)."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    sess = JSession.from_arch(ARCH, mode="nestpipe", store="device", data_seed=0,
                              ckpt_dir=d, ckpt_every=3, **KW)
    rep = sess.train(6)
    return d, rep.stats.losses, jax.tree.map(_np, rep.state)


def test_jax_checkpoint_trains_on_in_the_port(jax_dlrm_run):
    """JAX's step-3 checkpoint, read into the port and trained 3 steps,
    within 1e-5 of JAX's step-6 checkpoint; the step-6 read equals
    train_state_from_jax of the same leaves bit for bit."""
    d, jlosses, jfinal = jax_dlrm_run
    assert jlatest_step(d) == 6 and sorted(os.listdir(d)) == ["step_00000003",
                                                              "step_00000006"]
    sess = _session(mode="nestpipe", store="device", seed=5, data_seed=0)
    sess.state = train_state_from_jax_checkpoint(d, "cpu", step=3)
    assert int(sess.state.step) == 3 and int(sess.state.opt.step) == 3
    rep = sess.train(3)
    np.testing.assert_allclose(rep.stats.losses, jlosses[3:], atol=1e-5, rtol=0)
    step6 = train_state_from_jax_checkpoint(d, "cpu")  # the latest
    assert int(step6.step) == int(sess.state.step) == 6
    assert _max_gap(sess.state, step6) <= 1e-5
    jread = jax.tree.map(_np, jrestore_checkpoint(d, jfinal, 6))
    _assert_same_state(step6, train_state_from_jax(jread, "cpu"))
    _assert_same_state(step6, train_state_from_jax(jfinal, "cpu"))


@pytest.mark.parametrize("arch", ["hstu-industrial", "fuxi-kuairand"])
def test_jax_hstu_and_fuxi_checkpoints_read_bit_equal(tmp_path, arch):
    """A checkpoint JAX's save_checkpoint writes of a state with the JAX
    session's init structure (its leaves drawn from a seed, so the moments
    are not zeros) reads into the port equal to train_state_from_jax, bit
    for bit: the stacked layers unstacked."""
    jsess = JSession.from_arch(arch, reduced=True, global_batch=16)
    opt = jsess.optimizer
    shapes = jax.eval_shape(lambda k: jsess.workload.init_state(k, opt),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    state = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) if x.dtype.kind == "f"
                   else rng.integers(0, 100, x.shape)).astype(x.dtype), shapes)
    jsave_checkpoint(str(tmp_path), state, 0)
    got = train_state_from_jax_checkpoint(str(tmp_path), "cpu")
    _assert_same_state(got, train_state_from_jax(state, "cpu"))
    assert "layers.1.w_o" in got.dense or "layers.1.attn.wq" in got.dense


# ---------------------------------------------------------------------------
# (c) port save, restore, resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("save_tier,restore_tier,async_stages", [
    ("device", "device", "off"), ("device", "device", "on"),
    ("host", "host", "off"), ("host", "host", "on"),
    ("cached", "cached", "off"), ("cached", "cached", "on"),
    ("cached", "device", "off")])
def test_mid_run_save_restores_and_resumes_bit_for_bit(
        tmp_path, save_tier, restore_tier, async_stages):
    """A saves at step 3 of 5 through the driver's seam; B (another init
    seed, the same data seed) restores it and trains 2: A's first 3 steps
    with B's 2 equal A's uninterrupted run, the final state too. Bit for
    bit."""
    d = str(tmp_path)
    a = _session(store=save_tier, async_stages=async_stages, ckpt_dir=d,
                 ckpt_every=SAVE_AT)
    rep_a = a.train(STEPS)
    losses, final = rep_a.stats.losses, a.state
    assert sorted(os.listdir(d)) == ["step_00000003"]
    b = _session(store=restore_tier, async_stages=async_stages, seed=1,
                 data_seed=0, ckpt_dir=d)
    assert b.restore_if_available() == SAVE_AT
    assert int(b.state.step) == SAVE_AT
    rep_b = b.train(STEPS - SAVE_AT)
    assert rep_a.stats.losses[:SAVE_AT] + rep_b.stats.losses == losses
    _assert_same_state(b.state, final)


def test_serial_restart_is_exact(tmp_path):
    """Serial mode: A saves at step 3 of 5 through the serial loop's seam;
    B, from another seed, restores it and trains 2: A's last two losses
    and final state, bit for bit."""
    a = _session(mode="serial", ckpt_dir=str(tmp_path), ckpt_every=SAVE_AT)
    losses = a.train(STEPS).stats.losses
    b = _session(mode="serial", seed=77, data_seed=0, ckpt_dir=str(tmp_path))
    b.restore()
    assert int(b.state.step) == SAVE_AT
    assert b.train(STEPS - SAVE_AT).stats.losses == losses[SAVE_AT:]
    _assert_same_state(b.state, a.state)


def _driver_run(tier, async_on, every=2):
    """``STEPS`` steps through a driver saving every ``every`` steps (0:
    none): the exported states by step, the losses, the final state."""
    sess = _session(store=tier)
    exported = {}

    def on_ckpt(state, n):
        exported[n] = clone_state(state)

    driver = sess.strategy.build_driver(
        sess.fns, resolve_stream(sess.workload, sess.data_seed), sess.workload,
        async_stages=async_on, on_checkpoint=on_ckpt, ckpt_every=every)
    state, stats = driver.run(sess._take_state(), STEPS)
    return exported, stats.losses, state


@pytest.mark.parametrize("tier", ["device", "host", "cached"])
def test_checkpoint_export_drains_pending_commits(tier):
    """The state a driver hands its checkpoint callback under async stages
    holds every submitted commit: it equals the synchronous export at steps
    2 and 4, bit for bit, and carries the master, not the placeholder. The
    exports leave the run as a run without them, bit for bit."""
    sync, losses, final = _driver_run(tier, False)
    asyn, _, _ = _driver_run(tier, True)
    assert sorted(sync) == sorted(asyn) == [2, 4]
    for n in sync:
        assert sync[n].table.rows.shape[0] > 0 and int(sync[n].step) == n
        _assert_same_state(asyn[n], sync[n])
    none, plain_losses, plain_final = _driver_run(tier, False, every=0)
    assert none == {} and plain_losses == losses
    _assert_same_state(plain_final, final)


def test_save_time_stays_out_of_the_step_times():
    """A slow save is no step's time: the steps after it are not flagged as
    stragglers and their spans stay short (the drain re-marks its clock)."""
    sess = _session()
    pause = 0.5

    def slow_save(state, n):
        time.sleep(pause)

    driver = sess.strategy.build_driver(
        sess.fns, resolve_stream(sess.workload, sess.data_seed), sess.workload,
        on_checkpoint=slow_save, ckpt_every=2, metrics_every=1)
    _, stats = driver.run(sess._take_state(), STEPS)
    assert stats.straggler_steps == []
    assert max(stats.step_times[1:]) < pause / 2, stats.step_times


# ---------------------------------------------------------------------------
# (d) damage
# ---------------------------------------------------------------------------


def _two_checkpoints(d):
    """Checkpoints at steps 1 and 2 of one state, the later one's step leaf
    told apart."""
    sess = _session(ckpt_dir=d)
    sess.save(step=1)
    state = sess.state._replace(step=torch.tensor(2, dtype=torch.int32))
    save_checkpoint(d, state, 2)
    return sess


def _largest_leaf(step_dir):
    m = json.loads(open(os.path.join(step_dir, "manifest.json")).read())
    e = max(m["leaves"], key=lambda e: os.path.getsize(os.path.join(step_dir, e["file"])))
    return os.path.join(step_dir, e["file"])


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _flip(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        raw = f.read(8)
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in raw))


@pytest.mark.parametrize("damage", [_truncate, _flip])
def test_damaged_leaf_fails_crc_and_restore_falls_back(tmp_path, damage):
    d = str(tmp_path)
    sess = _two_checkpoints(d)
    damage(_largest_leaf(os.path.join(d, "step_00000002")))
    template = clone_state(sess.state)
    with pytest.raises(ValueError, match="CRC32"):
        restore_checkpoint(d, template, 2)
    _assert_same_state(template, sess.state)  # nothing written
    state, step = restore_latest_verifiable(d, template)
    assert step == 1 and int(state.step) == 0
    fresh = _session(seed=3, ckpt_dir=d)
    assert fresh.restore_if_available() == 1
    _assert_same_state(fresh.state, sess.state)
    damage(_largest_leaf(os.path.join(d, "step_00000001")))
    with pytest.raises(FileNotFoundError, match="no verifiable checkpoint"):
        restore_latest_verifiable(d, template)
    assert _session(ckpt_dir=d).restore_if_available() is None


def _edit_manifest(step_dir, edit):
    p = os.path.join(step_dir, "manifest.json")
    m = json.loads(open(p).read())
    edit(m)
    open(p, "w").write(json.dumps(m))


def test_manifest_without_checksums_restores(tmp_path):
    d = str(tmp_path)
    sess = _two_checkpoints(d)
    _edit_manifest(os.path.join(d, "step_00000001"),
                   lambda m: [e.pop("crc32") for e in m["leaves"]])
    got = restore_checkpoint(d, _session(seed=9).state, 1)
    _assert_same_state(got, sess.state)


@pytest.mark.parametrize("what", ["path", "shape", "dtype", "count"])
def test_structure_mismatch_raises(tmp_path, what):
    d = str(tmp_path)
    sess = _two_checkpoints(d)

    def edit(m):
        e = m["leaves"][-2]  # .table.accum
        if what == "path":
            e["path"] = ".table.acc"
        elif what == "shape":
            e["shape"] = [e["shape"][0] + 1]
        elif what == "dtype":
            e["dtype"] = "float64"
        else:
            m["leaves"].pop()

    _edit_manifest(os.path.join(d, "step_00000002"), edit)
    template = _session(seed=4).state
    before = clone_state(template)
    with pytest.raises(ValueError):
        restore_checkpoint(d, template, 2)
    _assert_same_state(template, before)
    assert restore_latest_verifiable(d, template)[1] == 1
    _assert_same_state(template, sess.state)


# ---------------------------------------------------------------------------
# (e) misuse
# ---------------------------------------------------------------------------


def test_placeholder_is_refused_unless_the_store_exports(tmp_path):
    sess = _session()
    state = clone_state(sess.state)
    store = HostStore(sess.workload.engine, n_micro=4)
    mid = state._replace(table=store.ingest(state.table))
    with pytest.raises(ValueError, match="placeholder"):
        save_checkpoint(str(tmp_path), mid, 0)
    with pytest.raises(ValueError, match="placeholder"):
        save_checkpoint(str(tmp_path), state._replace(
            table=placeholder_table(state.table)), 0)
    save_checkpoint(str(tmp_path), mid, 0, store=store)
    _assert_same_state(restore_checkpoint(str(tmp_path), _session(seed=2).state), state)
    store.release()
    with pytest.raises(ValueError, match="owns_master"):
        save_checkpoint(str(tmp_path), mid, 1, store=store)


def test_save_and_restore_need_a_ckpt_dir():
    sess = _session()
    with pytest.raises(ValueError, match="ckpt_dir"):
        sess.save()
    with pytest.raises(ValueError, match="ckpt_dir"):
        sess.restore()
    assert sess.restore_if_available() is None


def test_failed_restore_leaves_the_session_as_it_was(tmp_path):
    d = str(tmp_path)
    _session(ckpt_dir=d).save(step=1)
    _flip(_largest_leaf(os.path.join(d, "step_00000001")))
    sess = _session(seed=1, ckpt_dir=d)
    state = sess.state
    before = clone_state(state)
    with pytest.raises(ValueError, match="CRC32"):
        sess.restore()
    assert sess.state is state
    _assert_same_state(sess.state, before)
    assert sess.restore_if_available() is None
    assert sess.state is state


def test_restore_serves_the_restored_weights(tmp_path):
    """weights() after a restore serves the restored dense params, not the
    module built from the init before it."""
    d = str(tmp_path)
    a = _session(ckpt_dir=d)
    a.train(2)
    a.save()
    b = _session(seed=1, ckpt_dir=d)
    stale, _ = b.weights()
    b.restore()
    model, table = b.weights()
    assert model is not stale
    for k, v in model.state_dict().items():
        assert torch.equal(v, a.state.dense[k]), k
    assert torch.equal(table.rows, a.state.table.rows)


def test_leaf_without_a_numpy_dtype_is_refused_before_writing(tmp_path):
    """A leaf of a type numpy has no dtype for (a complex one; bf16 is
    written as JAX writes it, below) is refused, by its path, before any
    leaf of the state is written."""
    state = {"a": torch.zeros(3), "w": torch.zeros(3, dtype=torch.complex64)}
    with pytest.raises(ValueError, match=r"^\['w'\]: no numpy dtype for torch\.complex64"):
        save_checkpoint(str(tmp_path), state, 0)
    assert os.listdir(tmp_path) == []  # refused before anything was written


# ---------------------------------------------------------------------------
# (e) bfloat16 leaves: a bf16 LM's state
# ---------------------------------------------------------------------------

BF16_ARCH = "olmoe-1b-7b"  # reduced (2 layers, 8 experts top-2), in bf16


def _bf16_lm_session(**kw):
    """The reduced olmoe with bf16 params and compute (norm scales and the
    router f32, as a bf16 model holds them) on the CPU, through the build
    path."""
    from repro_torch.configs import ArchSpec, get_arch
    from repro_torch.launch.build import assemble_workload

    import dataclasses

    cfg = dataclasses.replace(get_arch(BF16_ARCH).reduced, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    wl = assemble_workload(ArchSpec(cfg.name, "lm", cfg, cfg), cfg, device="cpu",
                           global_batch=8, seq_len=16, t_chunk=16)
    return Session.from_workload(wl, **kw)


def _as_numpy(t):
    """A port tensor as JAX's numpy leaf: a bf16 one as an ml_dtypes array."""
    import ml_dtypes

    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_bf16_leaf_files_equal_jax_s(tmp_path, monkeypatch):
    """The port's save of a bf16 LM state, through chunks of 1,000 bytes,
    and JAX's save of the same leaves (the same tree, as numpy and
    ml_dtypes arrays): the same manifest and the same leaf files, byte for
    byte (descr '<V2', dtype "bfloat16", CRC32 included)."""
    monkeypatch.setattr(ck, "CHUNK_BYTES", 1000)
    state = _bf16_lm_session(seed=0).state
    dtypes = {str(x.dtype) for _, x in _leaves(state)}
    assert {"torch.bfloat16", "torch.float32", "torch.int32"} <= dtypes
    port = save_checkpoint(str(tmp_path / "port"), state, 4)
    jax_dir = jsave_checkpoint(str(tmp_path / "jax"),
                               jax.tree.map(_as_numpy, state), 4)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir))
    for name in sorted(os.listdir(port)):
        with open(os.path.join(port, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    manifest = json.loads(open(os.path.join(port, "manifest.json")).read())
    bf16 = [e for e in manifest["leaves"] if e["dtype"] == "bfloat16"]
    assert bf16 and all(".moe.router" not in e["path"] for e in bf16)
    raw = open(os.path.join(port, bf16[0]["file"]), "rb").read()
    assert raw.startswith(b"\x93NUMPY\x01\x00") and b"'descr': '<V2'" in raw


def test_jax_bf16_checkpoint_reads_bit_for_bit(tmp_path):
    """A checkpoint JAX's save_checkpoint writes of a bf16 olmoe state
    (JAX's init structure, its leaves drawn from a seed, the dense ones
    of a bf16 model's types) reads into the port equal to
    train_state_from_jax of the same leaves, bit for bit; its bf16 leaves
    come back bf16. JAX's own restore cannot read such a leaf (ROADMAP,
    Queue 3), so no JAX round trip is asked for."""
    import ml_dtypes

    jsess = JSession.from_arch(BF16_ARCH, reduced=True, global_batch=8, seq_len=16)
    shapes = jax.eval_shape(lambda k: jsess.workload.init_state(k, jsess.optimizer),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)

    def draw(path, x):
        if x.dtype.kind != "f":
            return rng.integers(0, 100, x.shape).astype(x.dtype)
        a = rng.standard_normal(x.shape).astype(x.dtype)
        keys = jax.tree_util.keystr(path)
        bf16 = keys.startswith(".dense") and x.ndim > 2 and "router" not in keys
        return a.astype(ml_dtypes.bfloat16) if bf16 else a

    state = jax.tree_util.tree_map_with_path(draw, shapes)
    jsave_checkpoint(str(tmp_path), state, 0)
    got = train_state_from_jax_checkpoint(str(tmp_path), "cpu")
    _assert_same_state(got, train_state_from_jax(state, "cpu"))
    assert got.dense["blocks.0.moe.wi"].dtype == torch.bfloat16
    assert got.dense["blocks.0.moe.router"].dtype == torch.float32
    want = np.asarray(state.dense["blocks"][0]["moe"]["wo"]).view(np.int16)
    assert torch.equal(got.dense["blocks.0.moe.wo"].view(torch.int16),
                       torch.from_numpy(want))


def test_bf16_moe_run_saves_restores_and_resumes_bit_for_bit(tmp_path):
    """A bf16 olmoe-reduced session trains 2 steps and saves at step 2
    through the driver's seam, then trains 2 more; a session from another
    seed restores step 2 and trains 2: its losses and every leaf equal the
    first session's second run, bit for bit.

    Its reference is the run restarted at step 2, not one run of 4 steps:
    at bf16 compute the engine rounds a row it retrieves from the master
    to bf16, while a row that ``buffer_sync`` carries from the previous
    window keeps its f32 update, so any run that starts at step 2
    retrieves step 3's rows afresh and ends 8e-5 from the 4-step run's
    fourth loss, in JAX too (the next test; ROADMAP, Queue 3, an open
    fault). At f32 compute the two agree (the test after it)."""
    d = str(tmp_path)
    a = _bf16_lm_session(seed=0, data_seed=0, ckpt_dir=d, ckpt_every=2)
    a.train(2)
    assert sorted(os.listdir(d)) == ["step_00000002"]
    rep_a = a.train(2)
    b = _bf16_lm_session(seed=1, data_seed=0, ckpt_dir=d)
    assert int(b.restore(step=2).step) == 2
    assert b.state.dense["blocks.0.moe.wi"].dtype == torch.bfloat16
    rep_b = b.train(2)
    assert rep_b.stats.losses == rep_a.stats.losses
    _assert_same_state(b.state, a.state)


def test_bf16_run_split_at_a_step_leaves_the_run_through_in_both_packages(monkeypatch):
    """Why the bf16 resume above is held to the restarted run: in JAX too, a
    bf16 olmoe-reduced session that trains 2 steps and then 2 more ends
    apart from one that trains 4 at once, with no checkpoint between. From
    one initial state (JAX's) and one stream, in each package, the first
    three losses are the same bits and the fourth is not; the port's run
    through is within the bf16 tolerance of JAX's. A train call ends its
    pipeline, so the next one retrieves its first window's rows afresh,
    rounded to bf16, where the run through carries the f32 rows that
    ``buffer_sync`` updated (ROADMAP, Queue 3: an open fault of both
    packages)."""
    import dataclasses

    import repro.launch.build as jbuild
    from repro.configs.registry import ArchSpec as JArchSpec

    real = jbuild.get_arch

    def bf16_arch(name):
        a = real(name)
        return JArchSpec(a.name, a.kind, a.config, dataclasses.replace(
            a.reduced, param_dtype="bfloat16", compute_dtype="bfloat16"))

    monkeypatch.setattr(jbuild, "get_arch", bf16_arch)
    kw = dict(reduced=True, global_batch=8, seq_len=16, t_chunk=16, data_seed=0)
    jthrough = JSession.from_arch(BF16_ARCH, **kw)
    init = jax.tree.map(lambda x: np.array(x, copy=True), jthrough.state)
    jsplit = JSession.from_workload(jthrough.workload, data_seed=0)
    jsplit._fns, jsplit._optimizer = jthrough.fns, jthrough.optimizer  # compiled once
    jsplit.state = jax.tree.map(jax.numpy.asarray, init)
    runs = {"jax": (jthrough.train(4).stats.losses,
                    jsplit.train(2).stats.losses + jsplit.train(2).stats.losses)}
    port = []
    for _ in range(2):
        sess = _bf16_lm_session(data_seed=0)
        sess.state = train_state_from_jax(init, "cpu")
        port.append(sess)
    runs["port"] = (port[0].train(4).stats.losses,
                    port[1].train(2).stats.losses + port[1].train(2).stats.losses)
    for name, (through, split) in runs.items():
        assert through[:3] == split[:3] and through[3] != split[3], name
    np.testing.assert_allclose(runs["port"][0], runs["jax"][0], rtol=0.03)


def test_f32_moe_mid_run_save_resumes_the_uninterrupted_run(tmp_path):
    """olmoe-reduced at f32: A saves at step 2 of 4 inside its run; B (seed
    1) restores it and trains 2: A's uninterrupted run, bit for bit."""
    d = str(tmp_path)
    a = Session.from_arch(BF16_ARCH, reduced=True, device="cpu", global_batch=8,
                          seq_len=16, data_seed=0, ckpt_dir=d, ckpt_every=2)
    rep_a = a.train(4)
    b = Session.from_arch(BF16_ARCH, reduced=True, device="cpu", global_batch=8,
                          seq_len=16, seed=1, data_seed=0, ckpt_dir=d)
    assert int(b.restore(step=2).step) == 2
    rep_b = b.train(2)
    assert rep_a.stats.losses[:2] + rep_b.stats.losses == rep_a.stats.losses
    _assert_same_state(b.state, a.state)


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------


def test_cli_resumes_where_it_saved(tmp_path, capsys):
    """--ckpt-every 2 --steps 4, then --steps 6 --resume: the uninterrupted
    6-step run's last two losses and final state, bit for bit."""
    from repro_torch.launch.train import train

    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--global-batch", "32"]
    d = str(tmp_path / "ck")
    train(base + ["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"])
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004"]
    state, stats = train(base + ["--steps", "6", "--ckpt-dir", d, "--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    full_state, full_stats = train(base + ["--steps", "6"])
    assert stats.losses == full_stats.losses[4:]
    _assert_same_state(state, full_state)
    shutil.rmtree(d)
