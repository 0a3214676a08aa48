"""Port synthetic stream and key-centric clustering == the JAX package's,
byte for byte (both are numpy; the port keeps its own copy)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.configs.registry import get_arch as jget_arch
from repro.core.embedding.table import make_mega_table_spec as jmake_spec
from repro.core.fwp.clustering import cluster_batch as jcluster
from repro.data.synthetic import SyntheticRecsysStream as JStream
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core.embedding.table import make_mega_table_spec as tmake_spec
from repro_torch.core.fwp.clustering import cluster_batch as tcluster
from repro_torch.data.synthetic import SyntheticRecsysStream as TStream


@pytest.mark.parametrize("arch,reduced", [
    ("dlrm-ctr", True), ("dlrm-ctr", False), ("dlrm-cached", False),
    ("dlrm-drift", False), ("dlrm-growth", False)])
def test_stream_batches_byte_equal(arch, reduced):
    jcfg = jget_arch(arch).reduced if reduced else jget_arch(arch).config
    tcfg = tget_arch(arch).reduced if reduced else tget_arch(arch).config
    js = JStream(jcfg, jmake_spec(jcfg.tables, num_shards=1), 64,
                 zipf_a=jcfg.zipf_a, seed=5)
    ts = TStream(tcfg, tmake_spec(tcfg.tables, num_shards=1), 64,
                 zipf_a=tcfg.zipf_a, seed=5)
    for step in (0, 3):
        a, b = ts.make_batch(step), js.make_batch(step)
        for f in ("keys", "dense", "labels", "raw_keys"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def test_scramble_np_keeps_the_exact_uint64_form():
    cfg = tget_arch("dlrm-cached").config
    spec = tmake_spec(cfg.tables, num_shards=1)
    keys = np.arange(0, spec.padded_rows, 7, dtype=np.int64)
    got = TStream(cfg, spec, 8).scramble_np(keys)
    want = ((keys * spec.mix_mult + spec.mix_add) % spec.padded_rows).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(TStream(cfg, spec, 8).scramble_np(
        np.arange(spec.padded_rows)))) == spec.padded_rows  # a bijection


@pytest.mark.parametrize("scheme", ["idf_minkey", "idf_hash", "minkey", "minhash"])
@pytest.mark.parametrize("b", [64, 4096])  # 4096 x 26 takes the sort-pass freq
def test_cluster_batch_permutation_equal(scheme, b):
    rng = np.random.default_rng(b)
    keys = rng.zipf(1.3, size=(b, 26)).astype(np.int32) % 5000
    for n_micro in (1, 4):
        np.testing.assert_array_equal(
            tcluster(keys, n_micro, scheme=scheme),
            jcluster(keys, n_micro, scheme=scheme))
