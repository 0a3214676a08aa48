"""Port engine ops == JAX ``EmbeddingEngine(mesh=None)``, bit for bit.

The same numpy f32 table and the same synthetic key windows go through
``route_window``, ``retrieve``, ``lookup_from_buffer`` and
``lookup_from_master`` in both packages; every leaf of the plan and the
buffer, and every embedding, must be equal. The JAX side runs its gathers
through the reference backend and, in one case, the Pallas interpreter.
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
from repro.core.embedding.engine import LookupPlan as JLookupPlan
from repro.core.embedding.table import EmbeddingTableState as JTable
from repro.core.embedding.table import make_mega_table_spec as jmake_spec
from repro.data.synthetic import SyntheticRecsysStream
from repro_torch.configs.base import NestPipeConfig as TNP
from repro_torch.convert import table_from_jax
from repro_torch.core.embedding.engine import EmbeddingEngine as TEngine
from repro_torch.core.embedding.engine import LookupPlan as TLookupPlan
from repro_torch.core.embedding.table import make_mega_table_spec as tmake_spec
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
