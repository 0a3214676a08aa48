"""Fault tolerance in the port (``repro_torch.dist.fault``,
``repro_torch.dist.inject``, the host stores' retry seam, the DBP driver's
preemption guard and step watchdog, the checkpoint writer's corruption
sites, the session's fault policy and the train CLI's SIGTERM), against
the JAX package on the same inputs and against the port's own fault-free
runs (``tests/test_fault.py`` mirrored, its one-card columns: the sharded
and 2D-grid rows wait for the port's sharded tier).

Workload: the reduced ``dlrm-ctr`` (``global_batch=32``, N = 4,
``bucket_slack=4.0``) on the CPU, 5 steps (6 for the preemption cases).

- Spec grammar, schedules, resolution, ``retry_step``'s delays, the
  watchdog's events: the same results as the JAX package's, call for call.
- The chaos matrix (``CHAOS``: a fault at every store site, each once),
  host and cached tiers, async stages off and on (and at lookahead 3):
  the losses and the whole master equal the port's fault-free run bit for
  bit; the fault-free run lies within 1e-5 of JAX's (the trajectory
  tolerance of ``tests/test_torch_store.py``: f32 matmuls add in another
  order on XLA:CPU, so no two packages' runs share their bits); in the
  synchronous runs the recovery and traffic counters equal JAX's under the
  same schedule exactly.
- A CUDA error is sticky: the stores re-raise ``torch.AcceleratorError``
  and ``torch.OutOfMemoryError`` unretried.
- Preemption: a notice during step 3's save stops the run at that step
  boundary, the exit path saves, and a session from another seed resumes
  to the uninterrupted run's bits (losses, master, dense params, AdamW
  state); a torn final save falls back one step and replays it.
"""
import os
import signal
import sys
import threading

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro.dist.fault as jfault
from repro.api import Session as JSession
from repro.dist import FaultInjector as JFaultInjector
from repro.dist import StepWatchdog as JStepWatchdog
from repro.dist import parse_fault_spec as jparse_fault_spec
from repro.dist import resolve_fault_inject as jresolve_fault_inject
from repro.dist import retry_step as jretry_step
from repro_torch.api import Session, build_workload_store, resolve_stream
from repro_torch.api import session as session_mod
from repro_torch.convert import train_state_from_jax
from repro_torch.core.embedding.routing import SENTINEL
from repro_torch.core.store import CachedStore, FetchPlan, HostStore, build_store
from repro_torch.dist import (
    NULL_INJECTOR,
    FaultInjector,
    InjectedFault,
    PreemptionGuard,
    RetryExhausted,
    StepWatchdog,
    parse_fault_spec,
    resolve_fault_inject,
    restore_checkpoint,
    restore_latest_verifiable,
    retry_step,
    save_checkpoint,
)
from repro_torch.dist import checkpoint as ck
from repro_torch.dist import fault as tfault

ARCH = "dlrm-ctr"  # reduced: 3 tables, 5 feature slots, dim 16
KW = dict(reduced=True, global_batch=32, n_micro=4)
STEPS = 5
# tests/test_fault.py's schedule: every store site once (step=N counts the
# calls to its own site)
CHAOS = "plan:step=1;retrieve:step=2;commit:step=3;h2d:step=1"
N_CHAOS_SITES = 4
# recovery and traffic counters both packages keep, compared exactly
COUNTERS = ("faults_injected", "stage_retries", "commit_rollbacks", "h2d_bytes",
            "d2h_bytes", "wire_bytes", "idx_bytes", "cache_hits", "cache_misses",
            "cache_evictions", "h2d_bursts", "d2h_bursts", "cache_rows_used")
REF_STEPS, PREEMPT_AT = 6, 3


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for var in ("REPRO_STORE", "REPRO_CACHE_POLICY", "REPRO_SPARSE_COMM",
                "REPRO_ASYNC_STAGES", "REPRO_FAULT_INJECT"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """These runs are many small ops: under the suite's workers, more
    intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.array(x, copy=True)  # the JAX run donates its input buffers


def _session(**kw):
    return Session.from_arch(ARCH, device="cpu", **KW, **kw)


def run_port(tier, *, init=None, async_on=False, lookahead=1, steps=STEPS,
             fault_inject="off", backoff_s=0.0, **driver_kw):
    """Train ``steps`` steps through ``tier`` from ``init`` (a JAX state,
    default: the seed-0 session's) with the store the config builds,
    ``retry_backoff_s`` set to ``backoff_s``. Returns (state, stats, store)."""
    sess = _session(store=tier, async_stages="on" if async_on else "off",
                    prefetch_ahead=lookahead, fault_inject=fault_inject)
    if init is not None:
        sess.state = train_state_from_jax(init, "cpu")
    store = build_workload_store(sess.workload)
    store.retry_backoff_s = backoff_s
    driver = sess.strategy.build_driver(
        sess.fns, resolve_stream(sess.workload, sess.data_seed), sess.workload,
        store=store, **driver_kw)
    state, stats = driver.run(sess._take_state(), steps)
    return state, stats, store


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _assert_same_state(a, b):
    la, lb = ck.flatten_state(a), ck.flatten_state(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


# ---------------------------------------------------------------------------
# the spec grammar and the injector: JAX's results, call for call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "retrieve:step=7;commit:step=12,count=2;h2d:p=0.05,seed=3",
    CHAOS + ";d2h:step=5",
    " plan : step = 1 ; ; ckpt_torn:step=0",
    "",
])
def test_parse_fault_spec_equals_jax(spec):
    assert parse_fault_spec(spec) == jparse_fault_spec(spec)


@pytest.mark.parametrize("bad", [
    "retrieve",                      # no schedule
    "retrieve:",                     # empty body
    "retrieve:when=7",               # unknown key
    "retrieve:step=x",               # non-numeric
    "retrieve:step=1,p=0.5",         # step and p are exclusive
    "retrieve:count=2",              # neither step nor p
    "retrieve:p=1.5",                # p out of range
    "retrieve:step=1,count=0",       # count < 1
    "retrieve:step=1;retrieve:step=2",  # duplicate site
])
def test_parse_fault_spec_rejects_like_jax(bad):
    with pytest.raises(ValueError, match="fault spec") as got:
        parse_fault_spec(bad)
    with pytest.raises(ValueError, match="fault spec") as want:
        jparse_fault_spec(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["commit:step=2,count=2", "h2d:p=0.3,seed=7",
                                  "h2d:p=0.05", "retrieve:step=0;h2d:p=0.5,seed=1"])
def test_schedules_fire_like_jax(spec):
    """64 calls a site: the same ``should`` sequence and counters; ``fire``
    raises ``InjectedFault``, a RuntimeError, exactly where ``should`` says."""
    t, j = FaultInjector.from_spec(spec), JFaultInjector.from_spec(spec)
    sites = sorted(parse_fault_spec(spec)) + ["plan"]  # plan: never armed
    for site in sites:
        got = [t.should(site) for _ in range(64)]
        assert got == [j.should(site) for _ in range(64)], site
    assert t.counters() == j.counters() and t.counters()["faults_injected"] > 0
    fired = FaultInjector.from_spec(spec)
    site = sites[0]
    schedule = JFaultInjector.from_spec(spec)
    want = [schedule.should(site) for _ in range(64)]
    for armed in want:
        if armed:
            with pytest.raises(InjectedFault, match=f"site '{site}'"):
                fired.fire(site)
        else:
            fired.fire(site)
    assert issubclass(InjectedFault, RuntimeError)


@pytest.mark.parametrize("value,env", [
    (None, None), ("auto", None), ("commit:step=1", None), ("auto", "h2d:step=0"),
    ("off", "h2d:step=0"), ("", "h2d:step=0"), ("plan:step=2", "h2d:step=0")])
def test_resolution_precedence_equals_jax(monkeypatch, value, env):
    if env is not None:
        monkeypatch.setenv("REPRO_FAULT_INJECT", env)
    assert resolve_fault_inject(value) == jresolve_fault_inject(value)


def test_null_injector():
    assert NULL_INJECTOR.active is False and NULL_INJECTOR.counters() == {}
    NULL_INJECTOR.fire("retrieve")  # a no-op, never raises
    assert FaultInjector.from_spec(None) is NULL_INJECTOR
    assert FaultInjector.from_spec("") is NULL_INJECTOR
    with pytest.raises(ValueError, match="fault spec"):
        FaultInjector.from_spec("retrieve:wat=1")


# ---------------------------------------------------------------------------
# retry_step: JAX's delays, exhaustion
# ---------------------------------------------------------------------------


def _flaky(fails, exc=RuntimeError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise exc("transient")
        return "ok"
    return fn


@pytest.mark.parametrize("fails,retries,backoff,cap", [
    (4, 4, 0.5, 3.0), (3, 3, 1.0, 30.0), (2, 5, 0.05, 0.06)])
def test_retry_delays_equal_jax(monkeypatch, fails, retries, backoff, cap):
    """The same sleeps under the same jitter draws: exponential, capped,
    scaled by 0.5 + random(); ``on_retry`` sees each attempt first."""
    out = {}
    for name, mod, retry in (("port", tfault, retry_step), ("jax", jfault, jretry_step)):
        draws = iter(np.random.default_rng(0).random(16).tolist())
        sleeps, seen = [], []
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)
        monkeypatch.setattr(mod.random, "random", lambda: next(draws))
        assert retry(_flaky(fails), retries=retries, backoff_s=backoff,
                     max_backoff_s=cap,
                     on_retry=lambda a, e: seen.append((a, str(e)))) == "ok"
        out[name] = (sleeps, seen)
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == fails


def test_retry_exhaustion_raises_chained():
    with pytest.raises(RetryExhausted, match="failed after 4 attempts") as ei:
        retry_step(_flaky(10, OSError), retries=3, backoff_s=0.0)
    assert isinstance(ei.value.__cause__, OSError)
    assert isinstance(ei.value, RuntimeError)
    with pytest.raises(ValueError):  # not transient: passes straight out
        retry_step(_flaky(1, ValueError), retries=3, backoff_s=0.0)


# ---------------------------------------------------------------------------
# a CUDA error is not a transient: raised at once, never replayed
# ---------------------------------------------------------------------------


def _tiny_store(cls):
    sess = _session()
    store = cls.from_device_table(sess.workload.engine, sess.state.table)
    store.retry_backoff_s = 0.0
    keys = np.full((16,), SENTINEL, np.int32)
    keys[:4] = [1, 5, 9, 13]
    return store, FetchPlan(None, keys)


@pytest.mark.parametrize("cls", [HostStore, CachedStore], ids=["host", "cached"])
@pytest.mark.parametrize("stage", ["plan", "retrieve", "commit"])
@pytest.mark.parametrize("exc", [torch.AcceleratorError, torch.OutOfMemoryError,
                                 RuntimeError], ids=["accelerator", "oom", "runtime"])
def test_stores_raise_cuda_errors_unretried(cls, stage, exc):
    store, plan = _tiny_store(cls)
    calls = []

    def body(*args):
        calls.append(args)
        raise exc(f"{stage} body failed")

    setattr(store, f"_{stage}_body", body)
    call = {"plan": lambda: store.plan_from_window(None),
            "retrieve": lambda: store.retrieve(plan),
            "commit": lambda: store.commit(None, plan)}[stage]
    retried = store.retry_budget if exc is RuntimeError else 0
    with pytest.raises(RetryExhausted if retried else exc, match=f"{stage} body failed"):
        call()
    assert len(calls) == 1 + retried
    m = store.metrics()
    assert m["stage_retries" if stage != "commit" else "commit_rollbacks"] == retried
    assert m["commit_rollbacks" if stage != "commit" else "stage_retries"] == 0


# ---------------------------------------------------------------------------
# the watchdog and the guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factor,warmup,decay", [(3.0, 3, 0.9), (2.0, 0, 0.5),
                                                 (1.5, 5, 0.8)])
def test_watchdog_events_equal_jax(factor, warmup, decay):
    rng = np.random.default_rng(int(factor * 10) + warmup)
    times = rng.uniform(0.04, 0.06, 200)
    times[rng.integers(0, 200, 12)] *= rng.uniform(1.5, 8.0, 12)
    t, j = StepWatchdog(factor, warmup, decay), JStepWatchdog(factor, warmup, decay)
    flags = [(t.observe(i, float(x)), j.observe(i, float(x))) for i, x in enumerate(times)]
    assert all(a == b for a, b in flags)
    assert [(e.step, e.step_time_s, e.ema_s) for e in t.events] == \
        [(e.step, e.step_time_s, e.ema_s) for e in j.events]
    assert t.events and t.ema == j.ema


def test_preemption_guard_chains_and_restores():
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        g = PreemptionGuard(signals=(signal.SIGUSR1,))
        os.kill(os.getpid(), signal.SIGUSR1)
        assert g.should_checkpoint
        assert seen == [signal.SIGUSR1], "the previous handler must still fire"
        g.restore()
        assert not g.should_checkpoint
        os.kill(os.getpid(), signal.SIGUSR1)  # restore() reinstalled it
        assert seen == [signal.SIGUSR1] * 2 and not g.should_checkpoint
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_preemption_guard_trigger_and_off_main_thread():
    g = PreemptionGuard(signals=())
    assert not g.should_checkpoint
    g.trigger()
    assert g.should_checkpoint
    g.restore()
    before = signal.getsignal(signal.SIGUSR1)
    made = []
    th = threading.Thread(target=lambda: made.append(
        PreemptionGuard(signals=(signal.SIGUSR1,))))
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    assert made[0]._installed == []  # signal.signal raises off the main thread
    assert signal.getsignal(signal.SIGUSR1) is before


# ---------------------------------------------------------------------------
# the chaos matrix: a fault at every store site, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's seed-0 initial state and its fault-free host-tier run, and the
    store counters of its synchronous chaos runs on both tiers."""
    js = JSession.from_arch(ARCH, store="host", fault_inject="off", **KW)
    init = jax.tree.map(_np, js.state)
    rep = js.train(STEPS)
    out = {"init": init, "losses": list(rep.stats.losses),
           "table": jax.tree.map(_np, rep.state.table)}
    for tier in ("host", "cached"):
        out[tier] = JSession.from_arch(ARCH, store=tier, fault_inject=CHAOS,
                                       **KW).train(STEPS).stats.store_metrics
    return out


@pytest.fixture(scope="module")
def fault_free(jax_runs):
    """The port's fault-free runs from JAX's initial state, by tier."""
    return {tier: run_port(tier, init=jax_runs["init"]) for tier in ("host", "cached")}


@pytest.mark.parametrize("tier,async_on,lookahead", [
    ("host", False, 1), ("host", True, 1), ("cached", False, 1),
    ("cached", True, 1), ("host", True, 3), ("cached", True, 3)])
def test_chaos_matrix_recovers_bit_for_bit(jax_runs, fault_free, tier, async_on,
                                           lookahead):
    state, stats, store = run_port(tier, init=jax_runs["init"], async_on=async_on,
                                   lookahead=lookahead, fault_inject=CHAOS)
    ref_state, ref_stats, _ = fault_free[tier]
    assert stats.losses == ref_stats.losses
    assert torch.equal(state.table.rows, ref_state.table.rows)
    assert torch.equal(state.table.accum, ref_state.table.accum)
    # the fault-free run against JAX's, at the trajectory tolerance
    np.testing.assert_allclose(ref_stats.losses, jax_runs["losses"], rtol=0, atol=1e-5)
    assert _max_diff(ref_state.table.rows, jax_runs["table"].rows) <= 1e-5
    assert _max_diff(ref_state.table.accum, jax_runs["table"].accum) <= 1e-5
    s = stats.summary()
    assert s["faults_injected"] == N_CHAOS_SITES
    assert s["stage_retries"] >= 3  # plan + retrieve + h2d (inside retrieve)
    assert s["commit_rollbacks"] >= 1
    if not async_on and lookahead == 1:
        jm, pm = jax_runs[tier], stats.store_metrics
        for k in COUNTERS:
            if k in jm:
                assert pm[k] == jm[k], k


def test_exhausted_retries_stay_fatal():
    with pytest.raises(RetryExhausted, match="failed after 4 attempts"):
        run_port("host", fault_inject="retrieve:step=0,count=64")


@pytest.mark.parametrize("tier", ["host", "cached"])
def test_exhausted_retries_surface_labelled_under_async(tier):
    """A retrieve that outlives its budget on a stage worker fails the run
    at the next pop, labelled by stage and window."""
    with pytest.raises(RuntimeError, match="retrieve stage failed at window 1") as ei:
        run_port(tier, async_on=True, lookahead=3,
                 fault_inject="retrieve:step=1,count=64")
    assert isinstance(ei.value.__cause__, RetryExhausted)


def test_device_tier_parses_the_spec_only():
    sess = _session()
    assert build_store("device", sess.workload.engine,
                       fault_inject=CHAOS).metrics().get("faults_injected") is None
    with pytest.raises(ValueError, match="fault spec"):
        build_store("device", sess.workload.engine, fault_inject="retrieve:wat=1")


def test_env_arms_the_store(monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_INJECT", "commit:step=0")
    store = build_workload_store(_session(store="host").workload)
    assert store.faults.active
    assert build_workload_store(_session(store="host", fault_inject="off")
                                .workload).faults is NULL_INJECTOR


# ---------------------------------------------------------------------------
# checkpoints: the injector's corruption sites, restore walks past them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ckpt_torn", "ckpt_corrupt"])
def test_restore_falls_back_past_a_damaged_checkpoint(tmp_path, mode):
    d = str(tmp_path)
    good = _session(seed=1).state
    save_checkpoint(d, good, 1)
    save_checkpoint(d, _session(seed=2).state, 2,
                    injector=FaultInjector.from_spec(f"{mode}:step=0"))
    with pytest.raises(ValueError, match="CRC32"):
        restore_checkpoint(d, _session(seed=3).state)
    got, step = restore_latest_verifiable(d, _session(seed=3).state)
    assert step == 1
    _assert_same_state(got, good)


def test_restore_latest_verifiable_exhausts_loudly(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, _session().state, 1,
                    injector=FaultInjector.from_spec("ckpt_torn:step=0"))
    with pytest.raises(FileNotFoundError, match="no verifiable checkpoint"):
        restore_latest_verifiable(d, _session().state)


# ---------------------------------------------------------------------------
# preemption: save at the step boundary, resume to the same bits
# ---------------------------------------------------------------------------


_UNINTERRUPTED = {}


def _uninterrupted(tier, mode):
    key = (tier, mode)
    if key not in _UNINTERRUPTED:
        sess = _session(store=tier, mode=mode, data_seed=0)
        _UNINTERRUPTED[key] = (sess.train(REF_STEPS).stats.losses, sess.state)
    return _UNINTERRUPTED[key]


def _preempted_at_step_3(monkeypatch, sess):
    """Latch the session's guard during step 3's save (as a notice that
    lands mid-save); returns the steps saved, in order."""
    real, saved = session_mod.save_checkpoint, []

    def save_then_notice(d, state, step, **kw):
        out = real(d, state, step, **kw)
        saved.append(step)
        if step == PREEMPT_AT:
            sess.guard.trigger()
        return out

    monkeypatch.setattr(session_mod, "save_checkpoint", save_then_notice)
    return saved


@pytest.mark.parametrize("tier,async_on,mode", [
    ("host", "off", "nestpipe"), ("cached", "off", "nestpipe"),
    ("host", "on", "nestpipe"), ("device", "off", "serial")])
def test_preemption_save_resume_is_exact(tmp_path, monkeypatch, tier, async_on, mode):
    ref_losses, ref_state = _uninterrupted(tier, mode)
    kw = dict(store=tier, mode=mode, async_stages=async_on, ckpt_dir=str(tmp_path),
              data_seed=0)
    a = _session(seed=0, ckpt_every=1, **kw)
    saved = _preempted_at_step_3(monkeypatch, a)
    rep = a.train(REF_STEPS)
    # the driver polled the guard at the boundary, saved on its way out
    # (step 3 once more, the released state) and returned early
    assert rep.stats.preempted_at == PREEMPT_AT == rep.summary["preempted_at"]
    assert len(rep.stats.losses) == PREEMPT_AT and int(a.state.step) == PREEMPT_AT
    assert saved == [1, 2, 3, 3]
    b = _session(seed=1, **kw)
    assert b.restore_if_available() == PREEMPT_AT
    rep_b = b.train(REF_STEPS - PREEMPT_AT)
    assert rep_b.stats.preempted_at is None
    assert rep.stats.losses + rep_b.stats.losses == ref_losses
    _assert_same_state(b.state, ref_state)


def test_preempted_resume_survives_a_torn_final_save(tmp_path, monkeypatch):
    """The preemption save lands torn (the session's checkpoint injector
    tears its fourth save): the resume falls back to step 2 and replays
    step 3, to the same bits."""
    ref_losses, ref_state = _uninterrupted("host", "nestpipe")
    kw = dict(store="host", ckpt_dir=str(tmp_path), data_seed=0)
    a = _session(seed=0, ckpt_every=1, fault_inject="ckpt_torn:step=3", **kw)
    assert a.ckpt_injector.active
    saved = _preempted_at_step_3(monkeypatch, a)
    rep = a.train(REF_STEPS)
    assert rep.stats.preempted_at == PREEMPT_AT and saved == [1, 2, 3, 3]
    assert a.ckpt_injector.counters() == {"faults_injected": 1.0}
    assert rep.summary.get("faults_injected") == 0.0  # the store's: no site fired
    b = _session(seed=1, **kw)
    assert b.restore_if_available() == PREEMPT_AT - 1
    rep_b = b.train(REF_STEPS - PREEMPT_AT + 1)
    assert rep_b.stats.losses == ref_losses[PREEMPT_AT - 1:]
    _assert_same_state(b.state, ref_state)


def test_notice_after_the_last_boundary_saves_at_the_end(tmp_path):
    sess = _session(store="host", ckpt_dir=str(tmp_path))
    sess.guard.trigger()  # polled only where steps are left: none after step 1
    rep = sess.train(1)
    assert rep.stats.preempted_at is None
    assert restore_latest_verifiable(str(tmp_path), _session(seed=1).state)[1] == 1


# ---------------------------------------------------------------------------
# the policies' wiring: watchdog, session counters, the CLI
# ---------------------------------------------------------------------------


def test_watchdog_owns_straggler_detection(monkeypatch):
    """The drain hands every step's time to the watchdog: its events are
    the driver's straggler steps, and a retried retrieve's backoff (1 s
    here) shows in the step that waited for it."""
    class Recording(StepWatchdog):
        def __init__(self):
            super().__init__(factor=3.0, warmup=0)
            self.seen = []

        def observe(self, step, step_time_s):
            self.seen.append((step, step_time_s))
            return super().observe(step, step_time_s)

    monkeypatch.setattr(tfault.random, "random", lambda: 0.5)  # jitter 1.0
    wd = Recording()
    _, stats, _ = run_port("host", fault_inject="retrieve:step=3", backoff_s=1.0,
                           watchdog=wd, metrics_every=1)
    assert [t for t, _ in wd.seen] == list(range(STEPS))
    assert [e.step for e in wd.events] == stats.straggler_steps
    assert stats.summary()["stragglers"] == len(wd.events)
    # window 3 is retrieved while step 2 runs (lookahead 1)
    assert wd.seen[2][1] >= 1.0 > max(x for t, x in wd.seen if t != 2)
    replay = JStepWatchdog(factor=3.0, warmup=0)
    assert [t for t, x in wd.seen if replay.observe(t, x)] == stats.straggler_steps


def test_session_surfaces_recovery_counters(tmp_path):
    sess = _session(store="host", fault_inject="retrieve:step=1",
                    ckpt_dir=str(tmp_path), data_seed=0)
    report = sess.train(4)
    assert report.summary["faults_injected"] == 1.0
    assert report.summary["stage_retries"] >= 1.0
    assert report.summary["commit_rollbacks"] == 0.0
    assert report.summary["stragglers_flagged"] == report.stragglers
    assert sess.ckpt_injector.active  # the same spec, its own counters
    sess.save()
    assert sess.restore_if_available() == 4


def test_cli_installs_the_sigterm_guard(monkeypatch):
    """The train CLI builds its session with SIGTERM in
    ``preemption_signals`` (the test builds it without, so no handler is
    left behind in the test process)."""
    from repro_torch.launch.train import train

    real, seen = Session.from_arch.__func__, {}

    def from_arch(cls, arch, **kw):
        seen.update(kw)
        return real(cls, arch, **{**kw, "preemption_signals": ()})

    monkeypatch.setattr(Session, "from_arch", classmethod(from_arch))
    before = signal.getsignal(signal.SIGTERM)
    train(["--arch", ARCH, "--reduced", "--device", "cpu", "--global-batch", "32",
           "--steps", "2", "--store", "host"])
    assert seen["preemption_signals"] == (signal.SIGTERM,)
    assert signal.getsignal(signal.SIGTERM) is before
