"""Port engine ops == JAX ``EmbeddingEngine(mesh=None)``.

The same numpy f32 table and the same synthetic key windows go through
``route_window``, ``retrieve``, ``lookup_from_buffer`` and
``lookup_from_master`` in both packages; every leaf of the plan and the
buffer, and every embedding, must be equal. The JAX side runs its gathers
through the reference backend and, in one case, the Pallas interpreter.

The training ops (``grads_to_owner``, ``apply_window_to_buffer``,
``sync_buffers``, ``writeback``, ``apply_packets_to_master``) get the same
gradients, made with numpy: bit for bit when the gradients are
integer-valued (every sum is exact), within ``rtol=atol=1e-6`` otherwise
(segment sums may add in another order). The JAX ops run under ``jit``,
as its driver runs them: XLA fuses Adagrad's ``rows - scale * total`` into
one multiply-add, which the port computes with ``torch.addcmul``.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.configs.base import NestPipeConfig as JNP
from repro.configs.registry import get_arch
from repro.core.embedding.engine import EmbeddingEngine as JEngine
from repro.core.embedding.engine import GradPacket as JPacket
from repro.core.embedding.engine import LookupPlan as JLookupPlan
from repro.core.embedding.table import EmbeddingTableState as JTable
from repro.core.embedding.table import make_mega_table_spec as jmake_spec
from repro.data.synthetic import SyntheticRecsysStream
from repro_torch.configs.base import NestPipeConfig as TNP
from repro_torch.convert import table_from_jax
from repro_torch.core.embedding.engine import EmbeddingEngine as TEngine
from repro_torch.core.embedding.engine import GradPacket as TPacket
from repro_torch.core.embedding.engine import LookupPlan as TLookupPlan
from repro_torch.core.embedding.table import make_mega_table_spec as tmake_spec
from repro_torch.core.embedding.routing import SENTINEL
from repro_torch.kernels import embedding_gather as eg


def _eq(t, j):
    j = np.asarray(j)
    t = t.numpy()
    assert t.dtype == j.dtype and t.shape == j.shape, (t.dtype, j.dtype, t.shape, j.shape)
    np.testing.assert_array_equal(t, j)


def _setup(arch, reduced, n_micro, slack, backend, batch):
    cfg = get_arch(arch).reduced if reduced else get_arch(arch).config
    jspec = jmake_spec(cfg.tables, num_shards=1)
    tspec = tmake_spec(cfg.tables, num_shards=1)
    jeng = JEngine(jspec, None, ("model",), P(None, None),
                   JNP(bucket_slack=slack, kernel_backend=backend),
                   compute_dtype=jnp.float32)
    teng = TEngine(tspec, TNP(bucket_slack=slack), device="cpu",
                   compute_dtype=torch.float32)
    rng = np.random.default_rng(7)
    rows = rng.normal(size=(jspec.padded_rows, jspec.dim)).astype(np.float32)
    accum = rng.random(jspec.padded_rows).astype(np.float32)
    stream = SyntheticRecsysStream(cfg, jspec, batch * n_micro,
                                   zipf_a=cfg.zipf_a, seed=1)
    keys = stream.make_batch(0).keys.reshape(n_micro, batch, -1)
    keys[0, -1, :2] = np.iinfo(np.int32).max  # sentinel-padded slots
    return (jeng, JTable(jnp.asarray(rows), jnp.asarray(accum)), teng,
            table_from_jax(rows, accum, "cpu"), keys)


@pytest.mark.parametrize("arch,reduced,n_micro,slack,backend,batch", [
    ("dlrm-ctr", True, 1, 1.5, "reference", 8),
    ("dlrm-ctr", True, 2, 4.0, "interpret", 8),
    ("dlrm-cached", False, 1, 1.5, "reference", 32),
    ("dlrm-cached", False, 4, 0.05, "reference", 16),  # forced bucket overflow
])
def test_engine_ops_bitwise_equal(arch, reduced, n_micro, slack, backend, batch):
    jeng, jtab, teng, ttab, keys = _setup(arch, reduced, n_micro, slack,
                                          backend, batch)
    mb_shape = keys.shape[1:]
    assert dataclasses.asdict(teng.dims(mb_shape, n_micro)) == \
        dataclasses.asdict(jeng.dims(mb_shape, n_micro))

    jwin = jax.jit(jeng.route_window, static_argnums=1)(jnp.asarray(keys), n_micro)
    twin = teng.route_window(torch.from_numpy(keys), n_micro)
    for t, j in zip(twin.plans, jwin.plans):
        _eq(t, j)
    _eq(twin.buffer_keys, jwin.buffer_keys)
    assert int(teng.overflow_metric(twin)) == int(jeng.overflow_metric(jwin))
    if slack < 1:
        assert int(teng.overflow_metric(twin)) > 0

    jbuf = jax.jit(jeng.retrieve)(jtab, jwin)
    before = eg.launches
    tbuf = teng.retrieve(ttab, twin)
    for t, j in zip(tbuf, jbuf):
        _eq(t, j)

    jlook = jax.jit(jeng.lookup_from_buffer, static_argnums=(2, 3))
    for i in range(n_micro):
        jplan = JLookupPlan(*(x[i] for x in jwin.plans))
        tplan = TLookupPlan(*(x[i] for x in twin.plans))
        _eq(teng.lookup_from_buffer(tbuf, tplan, mb_shape, n_micro),
            jlook(jbuf, jplan, mb_shape, n_micro))

    jemb, jplan = jax.jit(jeng.lookup_from_master)(jtab, jnp.asarray(keys[0]))
    temb, tplan = teng.lookup_from_master(ttab, torch.from_numpy(keys[0]))
    _eq(temb, jemb)
    for t, j in zip(tplan, jplan):
        _eq(t, j)
    assert eg.launches == before  # CPU tensors never reach the kernel


def _close(t, j, integer):
    j = np.asarray(j)
    t = t.numpy()
    assert t.dtype == j.dtype and t.shape == j.shape
    if integer:
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("arch,reduced,n_micro,slack,backend,batch", [
    ("dlrm-ctr", True, 4, 1.5, "reference", 8),
    ("dlrm-ctr", True, 2, 4.0, "interpret", 8),
    ("dlrm-cached", False, 4, 1.5, "reference", 16),
])
def test_engine_training_ops_equal_jax(arch, reduced, n_micro, slack, backend,
                                       batch, integer):
    jeng, jtab, teng, ttab, keys = _setup(arch, reduced, n_micro, slack,
                                          backend, batch)
    mb_shape = keys.shape[1:]
    d = jtab.rows.shape[1]
    jwin = jax.jit(jeng.route_window, static_argnums=1)(jnp.asarray(keys), n_micro)
    twin = teng.route_window(torch.from_numpy(keys), n_micro)
    jbuf = jax.jit(jeng.retrieve)(jtab, jwin)
    tbuf = teng.retrieve(ttab, twin)

    # FWP backward: one packet per micro-batch
    rng = np.random.default_rng(11)
    j_g2o = jax.jit(jeng.grads_to_owner, static_argnums=(2, 3))
    jp, tp = [], []
    for i in range(n_micro):
        demb = rng.normal(size=mb_shape + (d,)).astype(np.float32)
        if integer:
            demb = np.round(demb * 4).astype(np.float32)
        jpk = j_g2o(JLookupPlan(*(x[i] for x in jwin.plans)), jnp.asarray(demb),
                    mb_shape, n_micro)
        tpk = teng.grads_to_owner(TLookupPlan(*(x[i] for x in twin.plans)),
                                  torch.from_numpy(demb), mb_shape, n_micro)
        _eq(tpk.keys, jpk.keys)
        _close(tpk.grads, jpk.grads, integer)
        jp.append(jpk)
        tp.append(tpk)
    jpk = JPacket(jnp.stack([p.keys for p in jp]), jnp.stack([p.grads for p in jp]))
    tpk = TPacket(torch.stack([p.keys for p in tp]), torch.stack([p.grads for p in tp]))

    # window end: segment sums into buffer space + rowwise adagrad
    jnew = jax.jit(jeng.apply_window_to_buffer)(jbuf, jpk)
    tnew = teng.apply_window_to_buffer(tbuf, tpk)
    _eq(tnew.keys, jnew.keys)
    for t, j in zip(tnew[1:], jnew[1:]):
        _close(t, j, integer)
    assert not torch.equal(tnew.rows, tbuf.rows)  # the update happened

    # serial baseline: packets straight into master row space
    for t, j in zip(teng.apply_packets_to_master(ttab, tpk),
                    jax.jit(jeng.apply_packets_to_master)(jtab, jpk)):
        _close(t, j, integer)

    # stage 4b against the next window's (stale) buffer, then stage 5''
    keys2 = np.ascontiguousarray(keys[::-1])
    jwin2 = jax.jit(jeng.route_window, static_argnums=1)(jnp.asarray(keys2), n_micro)
    twin2 = teng.route_window(torch.from_numpy(keys2), n_micro)
    jpre = jax.jit(jeng.retrieve)(jtab, jwin2)
    tpre = teng.retrieve(ttab, twin2)
    jsync = jax.jit(jeng.sync_buffers)(jnew, jpre)
    tsync = teng.sync_buffers(tnew, tpre)
    _eq(tsync.keys, jsync.keys)
    for t, j in zip(tsync[1:], jsync[1:]):
        _close(t, j, integer)
    hit = np.isin(tpre.keys.numpy(), tnew.keys.numpy()) \
        & (tpre.keys.numpy() != SENTINEL)
    assert hit.any() and not torch.equal(tsync.rows, tpre.rows)

    jtab2 = jax.jit(jeng.writeback)(jtab, jnew)
    rows_before = ttab.rows.clone()
    ttab2 = teng.writeback(ttab, tnew)
    assert ttab2.rows is ttab.rows  # in place
    for t, j in zip(ttab2, jtab2):
        _close(t, j, integer)
    assert not torch.equal(ttab2.rows, rows_before)
