"""The port's Mamba2 (``models.mamba``, the (mamba, ·) layers of the LM)
against the JAX package on the CPU, at ``mamba2-370m-reduced`` (2 layers,
d_model 64, 16 heads of 8, N 16, chunk 16) and ``jamba-v0.1-52b-reduced``
(Mamba:attention 3:1, MoE at odd offsets), f32 unless a test says
otherwise.

- ``_causal_conv`` with and without a state and ``ssd_chunked`` at chunk 16
  for L in {1, 2, 20, 32} (prompts shorter than K - 1, a padded last
  chunk): output and final state within 1e-5;
- the masked decay ``exp(where(mask, seg, -inf))`` equals JAX's
  ``where(mask, exp(seg), 0)`` bit for bit in the forward; at one chunk of
  L 64 and of L 256 (mamba2-370m's dt and A), the port's ``ssd_chunked``
  gradient is finite and within 1e-4 of JAX's finite one (through
  ``ssd_reference`` at L 64, through ``ssd_chunked`` at chunk 16 at L
  256), while ``jax.grad`` through JAX's ``ssd_chunked`` at the same chunk
  is not finite (why the port's form differs);
- ``make_lm_loss_fn``'s loss and every gradient against
  ``jax.value_and_grad`` within 1e-5; in bf16, the loss and each gradient
  within 3% of JAX's bf16 ones (a few named leaves held to JAX's f32
  gradient instead, no farther than JAX's own bf16 one plus 3%), and
  farther from the port's f32 ones than f32 rounding;
- prefill and 3 decode steps within 1e-5, the caches' names, shapes and
  dtypes JAX's (conv in the compute dtype after a prefill, f32 in
  ``init_lm_cache``; ssm f32);
- 3-step ``Session.train`` trajectories in nestpipe and serial against
  JAX's within ``atol=1e-5`` (AdamW eps 1e-6), nestpipe = serial = the
  port's reference trainer, async diverges;
- served tokens equal JAX's session's on the same weights;
- ``convert`` carries ``blocks.{p}.mamba.*`` with names, shapes and dtypes
  (``A_log`` f32 in a bf16 jamba); a reduced mamba state saves and
  restores to the same bits.

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
from repro.configs.base import MambaConfig as JMambaConfig
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import ParallelConfig
from repro.configs.registry import get_arch as jget_arch
from repro.core.embedding.table import init_table_state as jinit_table
from repro.core.embedding.table import make_mega_table_spec as jmake_spec
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro_torch.api import Session, resolve_stream
from repro_torch.configs import base as tbase
from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax, table_from_jax, train_state_from_jax
from repro_torch.core.consistency import build_reference_step
from repro_torch.data.pipeline import make_cluster_transform, stage_to_device
from repro_torch.dist import checkpoint as ck
from repro_torch.models import mamba as M
from repro_torch.models import transformer as TT
from repro_torch.train import clone_state, constant_lr

ARCHS = ["mamba2-370m", "jamba-v0.1-52b"]
ARCH = "mamba2-370m"  # reduced: 2 layers, d_model 64, 16 heads of 8, N 16, chunk 16
KW = dict(reduced=True, global_batch=8, seq_len=20, n_micro=2, t_chunk=32)
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


def _ssd_inputs(length, *, h=4, p=8, n=16, dt_scale=0.1, seed=0):
    """x (2, L, H, P), dt (2, L, H) in (0, dt_scale), A = -(1..H), B and C
    (2, L, 1, N), an entering state (2, H, P, N)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, length, h, p)).astype(np.float32)
    dt = (rng.uniform(size=(2, length, h)) * dt_scale).astype(np.float32)
    A = -np.arange(1, h + 1, dtype=np.float32)
    Bm = rng.normal(size=(2, length, 1, n)).astype(np.float32)
    Cm = rng.normal(size=(2, length, 1, n)).astype(np.float32)
    s0 = rng.normal(size=(2, h, p, n)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


# ---------------------------------------------------------------------------
# the conv and the SSD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 2, 20, 32])
def test_conv_and_ssd_chunked_match_jax(length):
    """At chunk 16 and K 4: L 1 and 2 are shorter than K - 1, L 20 pads its
    last chunk, L 32 fills two."""
    rng = np.random.default_rng(length)
    xc = rng.normal(size=(2, length, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    state = rng.normal(size=(2, 3, 24)).astype(np.float32)
    for st in (None, state):
        jy, jst = _jit(JM._causal_conv)(jnp.asarray(xc), jnp.asarray(w), jnp.asarray(b),
                                        None if st is None else jnp.asarray(st))
        ty, tst = M._causal_conv(torch.from_numpy(xc), torch.from_numpy(w),
                                 torch.from_numpy(b), None if st is None
                                 else torch.from_numpy(st))
        assert ty.shape == jy.shape and tst.shape == jst.shape == (2, 3, 24)
        assert _max_diff(ty, jy) <= 1e-5 and _max_diff(tst, jst) == 0.0
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(length)
    for init in (None, s0):
        jy, js = _jit(JM.ssd_chunked, static_argnums=5)(
            *map(jnp.asarray, (x, dt, A, Bm, Cm)), 16,
            None if init is None else jnp.asarray(init))
        ty, ts = M.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 16,
                               None if init is None else torch.from_numpy(init))
        assert ty.dtype == ts.dtype == torch.float32
        assert ty.shape == jy.shape and ts.shape == js.shape
        assert _max_diff(ty, jy) <= 1e-5 and _max_diff(ts, js) <= 1e-5


def test_ssd_chunked_equals_the_recurrence_with_groups():
    """Two groups of two heads each (B and C reach a group's heads by a
    broadcast view): the chunked form within 1e-5 of the port's own O(L)
    recurrence, and of JAX's chunked form."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(37, seed=3)
    Bm = np.concatenate([Bm, Bm[..., ::-1]], axis=2).copy()
    Cm = np.concatenate([Cm, -Cm], axis=2)
    ty, ts = M.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 16,
                           torch.from_numpy(s0))
    ry, rs = M.ssd_reference(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                             torch.from_numpy(s0))
    jy, js = _jit(JM.ssd_chunked, static_argnums=5)(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                                    16, jnp.asarray(s0))
    assert _max_diff(ty, ry) <= 1e-5 and _max_diff(ts, rs) <= 1e-5
    assert _max_diff(ty, jy) <= 1e-5 and _max_diff(ts, js) <= 1e-5


def test_masked_decay_equals_the_unmasked_form_bit_for_bit():
    """seg above the diagonal up to ~800 (exp overflows to inf there): the
    port's form and JAX's give the same bits; the port's gradient is finite,
    the transcription's is NaN."""
    q = 256
    a = np.cumsum(-np.random.default_rng(0).uniform(0, 3.2, size=(3, q)), axis=-1)
    ai = torch.from_numpy(a.astype(np.float32)).requires_grad_()
    mask = torch.ones((q, q), dtype=torch.bool).tril()
    seg = ai[..., :, None] - ai[..., None, :]
    port = torch.exp(torch.where(mask, seg, seg.new_full((), -float("inf"))))
    plain = torch.where(mask, torch.exp(seg), seg.new_zeros(()))
    assert float(seg.detach().max()) > 89 and torch.isinf(torch.exp(seg.detach())).any()
    assert torch.equal(port, plain)
    (g_port,) = torch.autograd.grad(port.sum(), ai, retain_graph=True)
    (g_plain,) = torch.autograd.grad(plain.sum(), ai)
    assert torch.isfinite(g_port).all() and not torch.isfinite(g_plain).all()


def _ssd_grads(inputs, chunk):
    """JAX's gradient of sum(y^2) + sum(state^2) with respect to x, dt, A,
    B, C and the entering state: through ``ssd_chunked`` at ``chunk``, or
    through ``ssd_reference`` (chunk None)."""
    def loss(x, dt, A, Bm, Cm, s0):
        y, s = (JM.ssd_reference(x, dt, A, Bm, Cm, s0) if chunk is None
                else JM.ssd_chunked(x, dt, A, Bm, Cm, chunk, s0))
        return jnp.sum(y ** 2) + jnp.sum(s ** 2)

    grads = _jit(jax.grad(loss, tuple(range(6))))(*map(jnp.asarray, inputs))
    return [np.asarray(g) for g in grads]


def _port_ssd_grads(inputs, chunk):
    leaves = [torch.from_numpy(v.copy()).requires_grad_() for v in inputs]
    y, s = M.ssd_chunked(*leaves[:5], chunk, leaves[5])
    return torch.autograd.grad((y ** 2).sum() + (s ** 2).sum(), leaves)


@pytest.mark.parametrize("length,reference", [(64, None), (256, 16)])
def test_chunk_gradient_is_finite_where_jax_s_is_not(length, reference):
    """mamba2-370m's scale: 32 heads, A down to -32, dt up to 0.1, one chunk
    of L (gaps up to 205 and 819: exp overflows). The port's gradient of
    sum(y^2) + sum(state^2) with respect to x, dt, A, B, C and the entering
    state is finite and within 1e-4 of the largest magnitude of JAX's
    finite one; JAX's through its ``ssd_chunked`` at the same chunk is not
    finite. At L 64 the finite one is through JAX's ``ssd_reference``; at
    the published chunk, L 256, through JAX's ``ssd_chunked`` at chunk 16,
    the same function (XLA compiles the 256-step recurrence's gradient in
    ~37 s)."""
    inputs = _ssd_inputs(length, h=32, p=4, n=8, seed=5)
    assert not all(np.isfinite(g).all() for g in _ssd_grads(inputs, length))
    want = _ssd_grads(inputs, reference)
    for name, g, w in zip(("x", "dt", "A", "B", "C", "state"),
                          _port_ssd_grads(inputs, length), want):
        assert np.isfinite(w).all() and torch.isfinite(g).all(), name
        assert _max_diff(g, w) <= 1e-4 * float(np.abs(w).max()), name


def test_decode_step_returns_new_states_and_leaves_its_inputs():
    """``mamba_decode_step`` at L = 1 equals the mixer over the prompt and
    the new token at once, and does not write the states it was given."""
    cfg = get_arch(ARCH).reduced
    jp = JM.init_mamba(jax.random.PRNGKey(2), cfg.d_model,
                       JMambaConfig(**dataclasses.asdict(cfg.mamba)))
    p = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 7, cfg.d_model))
                         .astype(np.float32))
    out, (conv, ssm) = M.mamba_mixer(p, x[:, :6], cfg.mamba)
    conv0, ssm0 = conv.clone(), ssm.clone()
    step, conv1, ssm1 = M.mamba_decode_step(p, x[:, 6:], cfg.mamba, conv, ssm)
    assert torch.equal(conv, conv0) and torch.equal(ssm, ssm0)
    whole, (conv_w, ssm_w) = M.mamba_mixer(p, x, cfg.mamba)
    assert _max_diff(step, whole[:, 6:]) <= 1e-5 and _max_diff(out, whole[:, :6]) <= 1e-5
    assert _max_diff(conv1, conv_w) <= 1e-5 and _max_diff(ssm1, ssm_w) <= 1e-5


# ---------------------------------------------------------------------------
# the whole LM: loss and gradients, prefill and decode
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_lm_params(arch, seed=0, param_dtype=None):
    """JAX's init of the reduced LM from ``PRNGKey(seed)``, as numpy: drawn
    once for the tests that share it (a JAX init compiles each draw)."""
    cfg = jget_arch(arch).reduced
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    return jax.tree.map(np.asarray, JT.init_lm_params(jax.random.PRNGKey(seed), cfg))


def _cfgs(arch, **overrides):
    jcfg = dataclasses.replace(jget_arch(arch).reduced, **overrides)
    tcfg = dataclasses.replace(get_arch(arch).reduced, **overrides)
    if jcfg.moe is not None:  # every expert picked: no top-k choice flips in bf16
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, top_k=jcfg.moe.num_experts))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, top_k=tcfg.moe.num_experts))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _loss_pair(arch, compute_dtype="float32"):
    """JAX's and the port's (loss, metrics, param grads, emb grad) on one
    batch of 2 x 40 tokens (chunk 16: three chunks, the last padded), JAX's
    params; an MoE routes every token to all its experts (``_cfgs``)."""
    jcfg, tcfg = _cfgs(arch, compute_dtype=compute_dtype)
    jp = _jax_lm_params(arch)
    rng = np.random.default_rng(7)
    emb = (rng.normal(size=(2, 40, jcfg.d_model)) * 0.5).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
    labels[1, -2:] = -1
    jloss = JT.make_lm_loss_fn(jcfg, ParallelConfig(), None, t_chunk=16)
    (jtotal, jmet), (jg, jge) = _jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                        has_aux=True))(
        jp, jnp.asarray(emb), {"labels": jnp.asarray(labels)})
    tp = {k: v.requires_grad_() for k, v in lm_params_from_jax(jp).items()}
    temb = torch.from_numpy(emb).requires_grad_()
    total, met = TT.make_lm_loss_fn(tcfg, t_chunk=16)(tp, temb,
                                                      {"labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(total, [*tp.values(), temb])
    jgrads = {k: _f32(v) for k, v in lm_params_from_jax(jax.tree.map(np.asarray, jg)).items()}
    return ((float(jtotal), jgrads, _f32(jge)),
            (float(total.detach()), {k: _f32(g) for k, g in zip(tp, grads[:-1])},
             _f32(grads[-1])))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax_value_and_grad(arch):
    (jtotal, jgrads, jge), (total, grads, ge) = _loss_pair(arch)
    assert abs(total - jtotal) <= 1e-5
    assert set(grads) == set(jgrads) and "blocks.0.mamba.A_log" in grads
    for k, g in grads.items():
        assert g.shape == jgrads[k].shape, k
        assert _max_diff(g, jgrads[k]) <= 1e-5, k
    assert _max_diff(ge, jge) <= 1e-5


# The leaves whose bf16 gradient lies farther than BF16_RTOL from JAX's bf16
# one, with that distance as a share of the largest magnitude (on the CPU).
BF16_WIDE_LEAVES = {
    "mamba2-370m": {"blocks.0.mamba.dt_bias": 0.0504},
    "jamba-v0.1-52b": {
        "blocks.0.mamba.conv_b": 0.0357, "blocks.0.mamba.wc": 0.0364,
        "blocks.1.attn.wo": 0.0407, "blocks.1.moe.router": 0.0389,
        "blocks.1.moe.wi": 0.0407, "blocks.1.norm1.scale": 0.0452,
        "blocks.2.mamba.A_log": 0.0719, "blocks.2.mamba.wc": 0.0339,
        "blocks.2.mamba.wdt": 0.0433, "blocks.2.mamba.wx": 0.0378,
        "blocks.3.mamba.A_log": 0.0733, "blocks.3.mamba.D": 0.0348,
        "blocks.3.mamba.wb": 0.0300, "blocks.3.mamba.wc": 0.0417,
        "blocks.3.moe.wi": 0.0311, "emb": 0.0409},
}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_compute_lm_loss_and_grads_match_jax(arch):
    """f32 params computing in bf16 (``_cast_tree`` rounds the stacked
    A_log, D, dt_bias, norm_scale and conv_b to bf16 in both): the loss
    within 3% of JAX's bf16 loss, and each gradient within 3% of its
    largest magnitude of JAX's bf16 gradient, but for the leaves in
    ``BF16_WIDE_LEAVES``. Those are held no farther from JAX's f32
    gradient than JAX's own bf16 gradient is, plus 3% of its largest
    magnitude. The run is in bf16: its loss and every gradient move from
    the port's f32 ones by far more than f32 rounding.

    The two packages round to bf16 at different places. mamba2's
    ``dt_bias`` gradient amplifies that to 5.0%. Jamba's 4 layers amplify
    it for 16 of its 61 leaves, to 3.0-7.3%: there JAX's own bf16 gradients
    move by up to 2.5% (median 1.1%) when its f32 params move by one ulp (a
    jitted init against the eager one), and lie up to 10.5% from its f32
    gradients (on the CPU)."""
    (jf, jgf, jgef), (tf, tgf, tgef) = _loss_pair(arch)
    (jb, jgb, jgeb), (tb, tgb, tgeb) = _loss_pair(arch, "bfloat16")
    assert abs(tb - jb) <= BF16_RTOL * abs(jb) and abs(jb - jf) <= BF16_RTOL * abs(jf)
    assert abs(tb - tf) > 100 * np.finfo(np.float32).eps * abs(tf)
    wide = BF16_WIDE_LEAVES[arch]
    assert set(wide) <= {*jgf, "emb"}
    for k, truth in [*jgf.items(), ("emb", jgef)]:
        got, want, f32 = (tgeb, jgeb, tgef) if k == "emb" else (tgb[k], jgb[k], tgf[k])
        assert _max_diff(got, f32) > 1e-3 * float(np.abs(f32).max()), k
        if k in wide:
            scale = float(np.abs(truth).max())
            assert _max_diff(got, truth) <= _max_diff(want, truth) + BF16_RTOL * scale, k
        else:
            assert _max_diff(got, want) <= BF16_RTOL * float(np.abs(want).max()), k


@functools.lru_cache(maxsize=None)
def _jax_prefill(cfg, cache_len):
    return _jit(lambda p, e: JT.lm_prefill(p, cfg, e, cache_len=cache_len))


@functools.lru_cache(maxsize=None)
def _jax_decode(cfg):
    return _jit(lambda p, e, c: JT.lm_decode_step(p, cfg, e, c))


def _cache_layout(caches):
    return [{n: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
             for n, v in c.items()} for c in caches]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """The prefill's logits and caches (k and v at an attention position,
    conv and ssm at a Mamba one), then 3 decode steps, within 1e-5; the
    caches' names, shapes and dtypes are those of JAX's prefill."""
    jcfg, tcfg = jget_arch(arch).reduced, get_arch(arch).reduced
    jp = _jax_lm_params(arch)
    tp = lm_params_from_jax(jp)
    rng = np.random.default_rng(21)
    emb = rng.normal(size=(2, 19, jcfg.d_model)).astype(np.float32) * 0.5
    jl, jc = _jax_prefill(jcfg, 22)(jp, jnp.asarray(emb))
    tl, tc = TT.lm_prefill(tp, tcfg, torch.from_numpy(emb), cache_len=22)
    assert _max_diff(tl, jl) <= 1e-5 and tc.length == int(jc.length) == 19
    assert _cache_layout(tc.caches) == [
        {n: (tuple(v.shape), str(v.dtype)) for n, v in c.items()} for c in jc.caches]
    for tpos, jpos in zip(tc.caches, jc.caches):
        for n in tpos:
            assert _max_diff(tpos[n], jpos[n]) <= 1e-5, n
    for _ in range(3):
        e = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32) * 0.5
        jl, jc = _jax_decode(jcfg)(jp, jnp.asarray(e), jc)
        tl, tc = TT.lm_decode_step(tp, tcfg, torch.from_numpy(e), tc)
        assert tl.shape == (2, jcfg.vocab_size) and _max_diff(tl, jl) <= 1e-5
    for tpos, jpos in zip(tc.caches, jc.caches):
        for n in tpos:
            assert _max_diff(tpos[n], jpos[n]) <= 1e-5, n


def test_cache_dtypes_are_jax_s_in_bf16():
    """bf16 jamba (params and compute): the prefill's caches carry JAX's
    dtypes (k, v and conv bf16; ssm f32) and shapes, its logits within 3%
    of JAX's largest; ``init_lm_cache`` keeps the conv state f32 as JAX's."""
    arch = "jamba-v0.1-52b"
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = _jax_lm_params(arch, param_dtype="bfloat16")
    emb = np.random.default_rng(3).normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    jl, jc = _jax_prefill(jcfg, 12)(jp, jnp.asarray(emb))
    tl, tc = TT.lm_prefill(lm_params_from_jax(jp), tcfg, torch.from_numpy(emb), cache_len=12)
    want = [{n: (tuple(v.shape), str(v.dtype)) for n, v in c.items()} for c in jc.caches]
    assert _cache_layout(tc.caches) == want
    assert {d for c in want for _, d in c.values()} == {"bfloat16", "float32"}
    assert _max_diff(tl, jl) <= BF16_RTOL * float(np.abs(_f32(jl)).max())
    jinit = JT.init_lm_cache(jcfg, 2, 12)
    tinit = TT.init_lm_cache(tcfg, 2, 12, device="cpu")
    assert _cache_layout(tinit.caches) == [
        {n: (tuple(v.shape), str(v.dtype)) for n, v in c.items()} for c in jinit.caches]


# ---------------------------------------------------------------------------
# Session.train against JAX's; serving; convert; checkpoints
# ---------------------------------------------------------------------------


def _port_session(init_np, mode):
    sess = Session.from_arch(ARCH, mode=mode, device="cpu",
                             opt_cfg=OptimizerConfig(lr=LR, eps=ADAM_EPS), **KW)
    sess.state = train_state_from_jax(init_np, "cpu")
    return sess


@pytest.fixture(scope="module")
def mamba_runs():
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
def test_mamba_trajectory_matches_jax(mamba_runs, mode):
    _, jrep, rep = mamba_runs[mode]
    jstate = jax.tree.map(_np, jrep.state)
    assert rep.summary["arch"] == ARCH and rep.summary["overflow_max"] == 0
    np.testing.assert_allclose(rep.stats.losses, jrep.stats.losses, rtol=0, atol=1e-5)
    jdense = lm_params_from_jax(jstate.dense)
    assert set(jdense) == set(rep.state.dense)
    for k, v in jdense.items():
        assert _max_diff(rep.state.dense[k], v) <= 1e-5, k
    assert _max_diff(rep.state.table.rows, jstate.table.rows) <= 1e-5
    assert _max_diff(rep.state.table.accum, jstate.table.accum) <= 1e-5


def _gap(a, b):
    return max([_max_diff(a.table.rows, b.table.rows),
                _max_diff(a.table.accum, b.table.accum)]
               + [_max_diff(a.dense[k], b.dense[k]) for k in a.dense])


def test_mamba_nestpipe_equals_serial_equals_reference_async_diverges(mamba_runs):
    init = mamba_runs["nestpipe"][0]
    sess = _port_session(init, "nestpipe")
    wl = sess.workload
    ref_step = build_reference_step(wl.bundle.loss_fn(wl.t_chunk), sess.optimizer,
                                    constant_lr(sess.opt_cfg.lr), wl.n_micro)
    transform = make_cluster_transform(wl.n_micro, "keycentric")
    stream = resolve_stream(wl, sess.seed)
    ref = clone_state(train_state_from_jax(init, "cpu"))
    for _ in range(STEPS):
        batch = transform(next(stream))
        ref, _ = ref_step(ref, stage_to_device({k: batch[k] for k in ("keys", "labels")},
                                               torch.device("cpu")))
    nest, serial = mamba_runs["nestpipe"][2].state, mamba_runs["serial"][2].state
    assert _gap(nest, ref) <= 1e-5 and _gap(serial, ref) <= 1e-5 and _gap(nest, serial) <= 1e-5
    assert _max_diff(mamba_runs["async"][2].state.table.rows, ref.table.rows) > 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_session_serve_tokens_equal_jax(arch):
    """Reduced, batch 2, prompt 8, gen 4, on JAX's own fresh init (params
    from ``PRNGKey(seed)``, table from ``PRNGKey(1)``)."""
    seed = 0
    jrep = JSession.from_arch(arch, reduced=True, seed=seed).serve(batch=2, prompt_len=8,
                                                                  gen=4)
    jcfg = jget_arch(arch).reduced
    jspec = jmake_spec(None, vocab_size=jcfg.vocab_size, dim=jcfg.d_model, num_shards=1)
    jtable = jinit_table(jax.random.PRNGKey(1), jspec, None, ("data",))
    sess = Session.from_arch(arch, reduced=True, seed=seed, device="cpu")
    sess.ingest(lm_params_from_jax(_jax_lm_params(arch, seed)),
                table_from_jax(np.asarray(jtable.rows), np.asarray(jtable.accum), "cpu"))
    rep = sess.serve(batch=2, prompt_len=8, gen=4)
    np.testing.assert_array_equal(rep.tokens, jrep.tokens)


def test_convert_carries_mamba_params():
    """A bf16 jamba (JAX's init, 4 layers): every Mamba leaf under the
    port's name, its shape, its dtype (A_log, D, dt_bias and norm_scale
    f32) and its bits; the port's own init has the same names, shapes and
    dtypes."""
    arch = "jamba-v0.1-52b"
    cfg = dataclasses.replace(jget_arch(arch).reduced, param_dtype="bfloat16")
    jp = _jax_lm_params(arch, param_dtype="bfloat16")
    tp = lm_params_from_jax(jp)
    d, m = cfg.d_model, cfg.mamba
    d_in, h = m.expand * d, m.expand * d // m.headdim
    gn, bf, f32 = m.n_groups * m.d_state, torch.bfloat16, torch.float32
    want = {"wz": ((1, d, d_in), bf), "wx": ((1, d, d_in), bf), "wb": ((1, d, gn), bf),
            "wc": ((1, d, gn), bf), "wdt": ((1, d, h), bf),
            "conv_w": ((1, m.d_conv, d_in + 2 * gn), bf), "conv_b": ((1, d_in + 2 * gn), bf),
            "A_log": ((1, h), f32), "D": ((1, h), f32), "dt_bias": ((1, h), f32),
            "norm_scale": ((1, d_in), f32), "wo": ((1, d_in, d), bf)}
    mixers = [mixer for mixer, _ in cfg.layer_pattern]
    for pos, mixer in enumerate(mixers):
        got = {k.split(".")[-1]: (tuple(v.shape), v.dtype) for k, v in tp.items()
               if k.startswith(f"blocks.{pos}.mamba.")}
        assert got == (want if mixer == "mamba" else {}), pos
    for name in want:
        np.testing.assert_array_equal(
            tp[f"blocks.0.mamba.{name}"].float().numpy(),
            np.asarray(jnp.asarray(jp["blocks"][0]["mamba"][name], jnp.float32)))
    own = TT.init_lm_params(dataclasses.replace(get_arch(arch).reduced,
                                                param_dtype="bfloat16"),
                            device="cpu", generator=torch.Generator())
    assert {k: (tuple(x.shape), x.dtype) for k, x in own.items()} == \
        {k: (tuple(x.shape), x.dtype) for k, x in tp.items()}


def _port_config(jcfg):
    """A JAX ``ModelConfig`` as the port's, field for field."""
    d = dataclasses.asdict(jcfg)
    for key, cls in (("attention", tbase.AttentionConfig), ("moe", tbase.MoEConfig),
                     ("mamba", tbase.MambaConfig), ("encoder", tbase.EncoderConfig),
                     ("frontend", tbase.FrontendConfig)):
        if d[key] is not None:
            d[key] = cls(**d[key])
    return tbase.ModelConfig(**d)


@pytest.mark.parametrize("arch,ported", [("mamba2-370m", True), ("jamba-v0.1-52b", True),
                                         ("whisper-base", False), ("pixtral-12b", True)])
def test_check_ported_takes_mamba_stacks_and_refuses_encoders_and_frontends(arch, ported):
    """``(mamba, none)`` and Jamba's ``(attn | mamba, mlp | moe)`` layers are
    ported, at full and reduced size, and so is the decoder-only stack
    behind a vision frontend (pixtral-12b: stub patches ahead of the text);
    the decoder-only stack refuses an encoder (whisper-base), which resolves
    as JAX's ``kind == "encdec"`` (its own model, ``models.encdec``)."""
    for jcfg in (jget_arch(arch).config, jget_arch(arch).reduced):
        cfg = _port_config(jcfg)
        if ported:
            TT._check_ported(cfg)
            assert get_arch(arch).config == _port_config(jget_arch(arch).config)
        else:
            with pytest.raises(NotImplementedError, match="not ported"):
                TT._check_ported(cfg)
            assert get_arch(arch).kind == jget_arch(arch).kind == "encdec"
            assert get_arch(arch).config == _port_config(jget_arch(arch).config)


def test_mamba_state_saves_and_restores_the_same_bits(tmp_path):
    """A reduced mamba2 session trains 2 steps and saves; a session from
    another seed restores it (every leaf the same bits) and both train 2
    more to the same losses and leaves."""
    d = str(tmp_path)
    kw = dict(reduced=True, device="cpu", global_batch=8, seq_len=20, data_seed=0,
              ckpt_dir=d)
    a = Session.from_arch(ARCH, **kw)
    a.train(2)
    a.save()
    b = Session.from_arch(ARCH, seed=1, **kw)
    assert int(b.restore().step) == 2
    la, lb = ck.flatten_state(a.state), ck.flatten_state(b.state)
    assert [p for p, _ in la] == [p for p, _ in lb]
    assert any(".mamba.A_log" in p for p, _ in la)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert b.train(2).stats.losses == a.train(2).stats.losses
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(ck.flatten_state(a.state), ck.flatten_state(b.state)))
