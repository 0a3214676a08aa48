"""The ported recsys workloads (copies of ``repro.configs.recsys_archs``).

``hstu-industrial`` is the paper's HSTU backbone at its published widths;
its master (151 M rows of dim 512, 309 GB of f32) does not fit one card,
so a run on one card keeps every width and cuts the vocabularies
(``HSTU_INDUSTRIAL_ONE_CARD``). ``dlrm-ctr`` is the Criteo-like DLRM at its published
widths; its 26 tables pack into 57,012,000 rows of dim 128, a 29.19 GB f32
master that fits one 80 GB card. ``fuxi-kuairand`` is the paper's FuXi
backbone at its published widths and full vocabularies: its two tables
pack into 32,027,000 rows of dim 256, a 32.80 GB f32 master that fits one
card whole. The other configs are the CPU-runnable bench cells.
"""
import dataclasses

from .base import RecsysModelConfig, SparseTableConfig

# HSTU on the Industrial-like dataset: one dominant item table at
# production cardinality plus context tables (paper Table II setting;
# emb_dim=512 per paper Fig. 10 sweep midpoint).
HSTU_INDUSTRIAL = RecsysModelConfig(
    name="hstu-industrial", backbone="hstu",
    tables=(
        SparseTableConfig("items", vocab_size=100_000_000, dim=512),
        SparseTableConfig("users", vocab_size=50_000_000, dim=512),
        SparseTableConfig("context", vocab_size=1_000_000, dim=512),
    ),
    d_model=1024, n_layers=4, n_heads=8, d_ff=4096, seq_len=1024,
    compute_dtype="bfloat16",  # halves the embedding All2All payload
)

# hstu-industrial on one 80 GB card: every published width, each vocabulary
# divided by 6.25 (16 M / 8 M / 160 k rows, a 49.48 GB f32 master); the full
# master needs the host tier. Not in the registry: it is trained through a
# hand-assembled workload (``launch.build.assemble_workload`` and
# ``Session.from_workload``), as the JAX package builds its custom configs.
HSTU_ROW_CUT = 6.25
HSTU_INDUSTRIAL_ONE_CARD = dataclasses.replace(HSTU_INDUSTRIAL, tables=tuple(
    dataclasses.replace(t, vocab_size=round(t.vocab_size / HSTU_ROW_CUT))
    for t in HSTU_INDUSTRIAL.tables))

HSTU_REDUCED = RecsysModelConfig(
    name="hstu-reduced", backbone="hstu",
    tables=(SparseTableConfig("items", vocab_size=4096, dim=32),),
    d_model=64, n_layers=2, n_heads=4, d_ff=128, seq_len=32,
)

# FUXI on KuaiRand-27K-like scale (paper Table II GPU-cluster setting).
FUXI_KUAIRAND = RecsysModelConfig(
    name="fuxi-kuairand", backbone="fuxi",
    tables=(
        SparseTableConfig("videos", vocab_size=32_000_000, dim=256),
        SparseTableConfig("users", vocab_size=27_000, dim=256),
    ),
    d_model=512, n_layers=4, n_heads=8, d_ff=2048, seq_len=512,
    compute_dtype="bfloat16",
)

FUXI_REDUCED = RecsysModelConfig(
    name="fuxi-reduced", backbone="fuxi",
    tables=(SparseTableConfig("videos", vocab_size=4096, dim=32),),
    d_model=64, n_layers=2, n_heads=4, d_ff=128, seq_len=32,
)

# DLRM-style CTR: criteo-like multi-table one-hot + bagged features.
DLRM_CTR = RecsysModelConfig(
    name="dlrm-ctr", backbone="dlrm",
    tables=tuple(
        SparseTableConfig(f"cat_{i}", vocab_size=v, dim=128)
        for i, v in enumerate(
            [40_000_000, 10_000_000, 5_000_000, 1_000_000] + [100_000] * 10 + [1000] * 12
        )
    ),
    d_model=128, n_layers=0, n_heads=1, d_ff=512, seq_len=1,
    num_dense_features=13,
)

# Routing-dominated bench cell: trivial dense net, wide multi-hot bags.
DLRM_ROUTING = RecsysModelConfig(
    name="dlrm-routing", backbone="dlrm",
    tables=(
        SparseTableConfig("items", vocab_size=400_000, dim=64, bag_size=8),
        SparseTableConfig("users", vocab_size=100_000, dim=64, bag_size=4),
        SparseTableConfig("context", vocab_size=10_000, dim=64, bag_size=4),
    ),
    d_model=32, n_layers=0, n_heads=1, d_ff=64, seq_len=1,
    num_dense_features=4,
)

# Cache-dominated bench cell: steep zipf (a=2.5) key stream.
DLRM_CACHED = RecsysModelConfig(
    name="dlrm-cached", backbone="dlrm",
    tables=(
        SparseTableConfig("items", vocab_size=100_000, dim=64, bag_size=8),
        SparseTableConfig("users", vocab_size=25_000, dim=64, bag_size=4),
        SparseTableConfig("context", vocab_size=10_000, dim=64, bag_size=4),
    ),
    d_model=32, n_layers=0, n_heads=1, d_ff=64, seq_len=1,
    num_dense_features=4,
    zipf_a=2.5,
)

# Drifting-vocabulary bench cell: the zipf head rotates every step.
DLRM_DRIFT = RecsysModelConfig(
    name="dlrm-drift", backbone="dlrm",
    tables=(
        SparseTableConfig("items", vocab_size=10_000, dim=64, bag_size=8),
        SparseTableConfig("users", vocab_size=4_000, dim=64, bag_size=4),
    ),
    d_model=32, n_layers=0, n_heads=1, d_ff=64, seq_len=1,
    num_dense_features=4,
    zipf_a=2.0,
    drift_keys_per_step=96,
)

# Growing-vocabulary bench cell: the live key prefix widens every step.
DLRM_GROWTH = RecsysModelConfig(
    name="dlrm-growth", backbone="dlrm",
    tables=(
        SparseTableConfig("items", vocab_size=10_000, dim=64, bag_size=8),
        SparseTableConfig("users", vocab_size=4_000, dim=64, bag_size=4),
    ),
    d_model=32, n_layers=0, n_heads=1, d_ff=64, seq_len=1,
    num_dense_features=4,
    zipf_a=1.6,
    growth_keys_per_step=256, growth_base_keys=1024,
)

DLRM_REDUCED = RecsysModelConfig(
    name="dlrm-reduced", backbone="dlrm",
    tables=(
        SparseTableConfig("cat_a", vocab_size=2048, dim=16),
        SparseTableConfig("cat_b", vocab_size=512, dim=16),
        SparseTableConfig("cat_c", vocab_size=128, dim=16, bag_size=3),
    ),
    d_model=16, n_layers=0, n_heads=1, d_ff=64, seq_len=1,
    num_dense_features=8,
)
