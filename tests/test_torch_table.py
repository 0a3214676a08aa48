"""Port table layout, scramble and configs == the JAX package's.

- ``MegaTableSpec`` fields (padded rows, mixer, offsets) match for
  ``dlrm-ctr``, its reduced config and ``dlrm-cached``;
- ``MegaTableSpec.scramble`` reproduces JAX's uint32 wrap bit for bit,
  including at Vp = 135,000 and 57,012,000 where the wrap disagrees with the
  exact affine form and is not a bijection (pinned here, not fixed);
- the copied configs and integer helpers match field for field.
"""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro import utils as jutils
from repro.configs import base as jbase
from repro.configs.registry import get_arch as jget_arch
from repro.core.embedding.table import make_mega_table_spec as jmake_spec
from repro_torch import utils as tutils
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import RECSYS_ARCHS
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core.embedding.table import (
    EmbeddingTableState,
    init_table_state,
    make_mega_table_spec as tmake_spec,
)

CASES = [("dlrm-ctr", False), ("dlrm-ctr", True), ("dlrm-cached", False)]


def _specs(arch, reduced):
    jcfg = jget_arch(arch).reduced if reduced else jget_arch(arch).config
    tcfg = tget_arch(arch).reduced if reduced else tget_arch(arch).config
    return (jmake_spec(jcfg.tables, num_shards=1),
            tmake_spec(tcfg.tables, num_shards=1))


@pytest.mark.parametrize("arch,reduced", CASES)
def test_mega_table_spec_fields_equal(arch, reduced):
    js, ts = _specs(arch, reduced)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.rows_per_shard == js.rows_per_shard


def test_dlrm_ctr_is_full_width():
    _, ts = _specs("dlrm-ctr", False)
    assert (ts.padded_rows, ts.dim) == (57_012_000, 128)
    assert ts.padded_rows * ts.dim * 4 == 29_190_144_000  # 29.19 GB of f32


@pytest.mark.parametrize("arch,reduced", CASES)
def test_scramble_reproduces_uint32_wrap_bitwise(arch, reduced):
    js, ts = _specs(arch, reduced)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, js.padded_rows, size=20_000).astype(np.int32)
    keys[:3] = [0, js.padded_rows - 1, js.padded_rows // 2]
    want = np.asarray(js.scramble(jnp.asarray(keys)))
    got = ts.scramble(torch.from_numpy(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for t, off in enumerate(ts.table_offsets):  # JAX's per-table mapping
        sub = keys[:100] % ts.table_vocabs[t]
        np.testing.assert_array_equal(
            ts.scramble(torch.from_numpy(sub) + off).numpy(),
            np.asarray(js.global_keys(t, jnp.asarray(sub))))


@pytest.mark.parametrize("arch", ["dlrm-cached", "dlrm-ctr"])
def test_uint32_scramble_is_not_the_exact_form_at_large_vp(arch):
    """The trap: past 2**32 the wrapped form leaves the exact affine map
    (and with it bijectivity). Both packages share it."""
    _, ts = _specs(arch, False)
    vp = ts.padded_rows
    keys = np.arange(0, vp, max(vp // 200_000, 1), dtype=np.int64)
    wrapped = ts.scramble(torch.from_numpy(keys.astype(np.int32))).numpy()
    exact = ((keys.astype(np.uint64) * ts.mix_mult + ts.mix_add) % vp).astype(np.int32)
    assert (wrapped != exact).mean() > 0.5  # 51.6% and 99.9995%
    if vp == 135_000:  # the whole key space: 115,936 distinct rows
        assert len(np.unique(wrapped)) == 115_936


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_configs_equal_field_for_field(arch):
    j, t = jget_arch(arch), tget_arch(arch)
    assert t.kind == j.kind == "recsys"
    for a, b in ((t.config, j.config), (t.reduced, j.reduced)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.total_sparse_rows == b.total_sparse_rows
        assert a.max_table_dim == b.max_table_dim


def test_nestpipe_config_fields_equal_their_jax_defaults():
    t, j = tbase.NestPipeConfig(), jbase.NestPipeConfig()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name


def test_integer_helpers_equal():
    for m in (7, 8, 128, 4096, 135_000, 510_000, 57_012_000):
        assert tutils.coprime_mixer(m) == jutils.coprime_mixer(m)
        for x in (0, 1, 13, m - 1, m, 3 * m + 5):
            assert tutils.round_up(x, 8) == jutils.round_up(x, 8)
            assert tutils.cdiv(x, m) == jutils.cdiv(x, m)


def test_init_table_state_is_seeded_and_in_place():
    _, ts = _specs("dlrm-ctr", True)
    a = init_table_state(ts, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    b = init_table_state(ts, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    assert isinstance(a, EmbeddingTableState)
    assert a.rows.shape == (ts.padded_rows, ts.dim) and a.rows.dtype == torch.float32
    assert torch.equal(a.rows, b.rows) and not a.accum.any()
    assert 0.008 < float(a.rows.std()) < 0.012


def test_same_device_names_one_device_two_ways():
    from repro_torch.utils import same_device

    assert same_device("cpu", torch.device("cpu"))
    assert not same_device("cpu", "cuda:0")
    assert not same_device("cuda:0", "cuda:1")


def test_optimizer_config_equals_jax_field_for_field():
    t, j = tbase.OptimizerConfig(), jbase.OptimizerConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
