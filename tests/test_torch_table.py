"""Port table layout, scramble and configs == the JAX package's.

- ``MegaTableSpec`` fields (padded rows, mixer, offsets) match for
  ``dlrm-ctr``, its reduced config and ``dlrm-cached``;
- ``MegaTableSpec.scramble`` reproduces JAX's uint32 wrap bit for bit,
  including at Vp = 135,000 and 57,012,000 where the wrap disagrees with the
  exact affine form and is not a bijection (pinned here, not fixed);
- the copied configs (DLRM, HSTU and FuXi) and integer helpers match
  field for field; ``fuxi-kuairand`` packs into its published 32,027,000
  rows of dim 256;
- the HSTU configuration trained on one card (``HSTU_INDUSTRIAL_ONE_CARD``)
  keeps every published width of ``hstu-industrial`` and cuts only its
  vocabularies;
- the LM configs (``AttentionConfig``, ``ModelConfig`` and the dataclasses
  it names) and the four dense archs' ``CONFIG`` and ``REDUCED`` match
  field for field, with ``layer_plan`` and ``param_count``; the
  single-vocab spec matches, and its scramble equals JAX's on every one of
  stablelm-12b's 100,352 keys and is a bijection there.
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
from repro_torch.configs.registry import LM_ARCHS, RECSYS_ARCHS
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core.embedding.table import (
    EmbeddingTableState,
    init_table_state,
    make_mega_table_spec as tmake_spec,
)

CASES = [("dlrm-ctr", False), ("dlrm-ctr", True), ("dlrm-cached", False),
         ("hstu-industrial", False), ("hstu-industrial", True),
         ("fuxi-kuairand", False), ("fuxi-kuairand", True)]


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


def test_fuxi_kuairand_is_full_width_and_fits_one_card():
    """Both tables at their published vocabularies and dim 256: 32,027,000
    rows, a 32.80 GB f32 master, and d_model 512, 4 layers, 8 heads, T 512,
    bf16 lookups."""
    js, ts = _specs("fuxi-kuairand", False)
    assert (ts.padded_rows, ts.dim) == (32_027_000, 256)
    assert ts.padded_rows * ts.dim * 4 == 32_795_648_000
    cfg = tget_arch("fuxi-kuairand").config
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.d_ff, cfg.seq_len,
            cfg.compute_dtype) == (512, 4, 8, 2048, 512, "bfloat16")


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


# The JAX NestPipeConfig fields the port leaves out on purpose, each with
# its reason or the ROADMAP item (port Queue 1) that ports it.
JAX_ONLY_NESTPIPE_FIELDS = {
    "dbp": "always-on",  # the DBP driver is the only pipelined loop
    "fwp_unroll": "XLA-only",  # unrolled window vs scan: an HLO-shape switch
    "dedup_remote": "item-6",  # the owner-side second dedup: multi-shard
    "grad_mode": "item-6",  # "dense_shard" grads: the sharded table
    "kernel_backend": "always-cuda",  # one hand-written kernel per op
    "dense_comm": "item-6",  # the quantized ring all-reduce: multi-rank
}


def test_nestpipe_config_fields_equal_their_jax_defaults():
    """Both directions: every port field has JAX's default, and the field
    sets differ by exactly the JAX-only list, so a JAX field the port
    should carry cannot go missing unseen."""
    t, j = tbase.NestPipeConfig(), jbase.NestPipeConfig()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    tnames = {f.name for f in dataclasses.fields(t)}
    jnames = {f.name for f in dataclasses.fields(j)}
    assert tnames <= jnames, sorted(tnames - jnames)
    assert jnames - tnames == set(JAX_ONLY_NESTPIPE_FIELDS), sorted(jnames - tnames)


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


def test_hstu_row_cut_keeps_every_width():
    """The one-card HSTU config: the JAX ``HSTU_INDUSTRIAL`` with each
    vocabulary divided by 6.25 (a 49.48 GB f32 master) and nothing else
    changed."""
    from repro_torch.configs.recsys_archs import HSTU_INDUSTRIAL_ONE_CARD as cut

    full = jget_arch("hstu-industrial").config
    assert cut.backbone == "hstu"
    for f in dataclasses.fields(full):
        if f.name != "tables":
            assert getattr(cut, f.name) == getattr(full, f.name), f.name
    assert (cut.d_model, cut.n_layers, cut.n_heads, cut.seq_len) == (1024, 4, 8, 1024)
    assert cut.compute_dtype == "bfloat16" and cut.max_table_dim == 512
    assert [(t.name, t.dim, t.bag_size, t.combiner) for t in cut.tables] == \
        [(t.name, t.dim, t.bag_size, t.combiner) for t in full.tables]
    assert [t.vocab_size for t in cut.tables] == [16_000_000, 8_000_000, 160_000]
    assert [t.vocab_size * 4 for t in cut.tables] == \
        [int(t.vocab_size * 4 / 6.25) for t in full.tables]
    spec = tmake_spec(cut.tables, num_shards=1)
    assert spec.padded_rows == 24_160_000
    assert spec.padded_rows * spec.dim * 4 == 49_479_680_000  # 49.48 GB of f32
    # the one-card config stays out of the registry
    from repro_torch.configs.registry import get_arch

    for name in RECSYS_ARCHS:
        spec_ = get_arch(name)
        assert cut.tables not in (spec_.config.tables, spec_.reduced.tables), name


@pytest.mark.parametrize("cls", ["AttentionConfig", "MoEConfig", "MambaConfig",
                                 "EncoderConfig", "FrontendConfig", "ModelConfig"])
def test_lm_config_classes_equal_field_for_field(cls):
    t, j = getattr(tbase, cls), getattr(jbase, cls)
    assert [(f.name, f.default) for f in dataclasses.fields(t)] == \
        [(f.name, f.default) for f in dataclasses.fields(j)]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_equal_field_for_field(arch):
    j, t = jget_arch(arch), tget_arch(arch)
    assert t.kind == j.kind == ("encdec" if arch == "whisper-base" else "lm")
    for a, b in ((t.config, j.config), (t.reduced, j.reduced)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.layer_plan == b.layer_plan
        assert a.param_count() == b.param_count()
    assert set(LM_ARCHS) == {"stablelm-12b", "stablelm-3b", "yi-34b", "nemotron-4-340b",
                             "olmoe-1b-7b", "grok-1-314b", "mamba2-370m", "jamba-v0.1-52b",
                             "whisper-base", "pixtral-12b"}


def test_olmoe_1b_7b_is_full_width():
    """The published widths; 6.92 B params, of which 6.82 B dense (the
    vocab table apart): 13.63 GB in bf16, whole on one card; a layer holds
    419.56 M, so 6 layers and the head are 2.62 B (the training cell's
    depth)."""
    cfg = tget_arch("olmoe-1b-7b").config
    a, m = cfg.attention, cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (16, 2048, 1024, 50304)
    assert (a.n_heads, a.n_kv_heads, a.head_dim) == (16, 16, 128)
    assert (m.num_experts, m.top_k, m.capacity_factor) == (64, 8, 1.25)
    assert cfg.param_dtype == cfg.compute_dtype == "bfloat16"
    assert cfg.layer_plan == (("attn", "moe"),) * 16
    assert cfg.param_count() == 6_919_094_272
    dense = cfg.param_count() - cfg.vocab_size * cfg.d_model
    assert dense == 6_816_071_680
    layer = (cfg.param_count() - 2 * cfg.vocab_size * cfg.d_model) // 16
    assert layer == 419_565_568
    assert 6 * layer + cfg.vocab_size * cfg.d_model == 2_620_416_000


def test_mamba2_370m_is_full_width():
    """The published widths, 48 (mamba, none) layers: 0.42 B params, 1.68
    GB in f32, trained whole on one card."""
    cfg = tget_arch("mamba2-370m").config
    m = cfg.mamba
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (48, 1024, 50288)
    assert (m.d_state, m.headdim, m.expand, m.n_groups, m.d_conv, m.chunk_size) == \
        (128, 64, 2, 1, 4, 256)
    assert cfg.layer_plan == (("mamba", "none"),) * 48 and cfg.attention is None
    assert (cfg.param_dtype, cfg.compute_dtype) == ("float32", "bfloat16")
    assert cfg.param_count() == 419_679_232


def test_jamba_v01_52b_is_full_width():
    """The published widths; one period of 8 layers (attention at offset 4,
    MoE at the odd offsets) holds 13.27 B params, 26.54 GB in bf16: the
    depth served on one card."""
    cfg = tget_arch("jamba-v0.1-52b").config
    a, m, e = cfg.attention, cfg.mamba, cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (32, 4096, 14336, 65536)
    assert (a.n_heads, a.n_kv_heads, a.head_dim) == (32, 8, 128)
    assert (m.d_state, m.headdim, m.expand, m.chunk_size) == (16, 64, 2, 256)
    assert (e.num_experts, e.top_k) == (16, 2)
    assert cfg.layer_plan[:8] == tuple(("attn" if i == 4 else "mamba",
                                        "moe" if i % 2 else "mlp") for i in range(8))
    assert cfg.param_count() == 51_459_533_312
    assert dataclasses.replace(cfg, n_layers=8).param_count() == 13_267_536_512


def test_stablelm_12b_is_full_width():
    cfg = tget_arch("stablelm-12b").config
    a = cfg.attention
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (40, 5120, 13824, 100352)
    assert (a.n_heads, a.n_kv_heads, a.head_dim) == (32, 8, 160)
    assert cfg.param_dtype == cfg.compute_dtype == "bfloat16"
    dense = cfg.param_count() - cfg.vocab_size * cfg.d_model  # the table is apart
    assert dense == 11_629_117_440  # 23.26 GB in bf16, the head included


@pytest.mark.parametrize("arch,reduced", [("stablelm-12b", False), ("stablelm-12b", True),
                                          ("stablelm-3b", False), ("nemotron-4-340b", False)])
def test_lm_vocab_spec_equal(arch, reduced):
    jcfg = jget_arch(arch).reduced if reduced else jget_arch(arch).config
    js = jmake_spec(None, vocab_size=jcfg.vocab_size, dim=jcfg.d_model, num_shards=1)
    ts = tmake_spec(None, vocab_size=jcfg.vocab_size, dim=jcfg.d_model, num_shards=1)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    with pytest.raises(ValueError, match="vocab_size"):
        tmake_spec(None, num_shards=1)


def test_lm_scramble_equals_jax_and_is_a_bijection_on_every_key():
    """stablelm-12b: Vp = 100,352, P = 25,009, A = 14,336. Every k * P + A
    stays below 2**32, so JAX's uint32 wrap never fires and the map is a
    permutation of the rows."""
    cfg = tget_arch("stablelm-12b").config
    ts = tmake_spec(None, vocab_size=cfg.vocab_size, dim=cfg.d_model, num_shards=1)
    js = jmake_spec(None, vocab_size=cfg.vocab_size, dim=cfg.d_model, num_shards=1)
    assert (ts.padded_rows, ts.mix_mult, ts.mix_add) == (100_352, 25_009, 14_336)
    keys = np.arange(ts.padded_rows, dtype=np.int32)
    got = ts.scramble(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, np.asarray(js.scramble(jnp.asarray(keys))))
    assert np.array_equal(np.sort(got), keys)
