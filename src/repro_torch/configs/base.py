"""Config dataclasses for the models (LM and recsys), the NestPipe
switches the serving and training paths read, and the optimizer
(field-for-field copies of ``repro.configs.base``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# LM-side configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    causal: bool = True
    # The JAX package's attention implementation ("chunked" | "naive" |
    # "pallas"). All three compute one function; the port reads none of
    # them and always runs the flash_attention op (kernels/dispatch.py).
    impl: str = "chunked"
    q_chunk: int = 1024
    kv_chunk: int = 1024
    qk_norm: bool = False


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper)."""

    n_layers: int
    n_frames: int  # stub conv frontend output length
    d_model: int = 0  # 0 => same as decoder d_model


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: precomputed embeddings."""

    kind: str  # "audio" | "vision"
    n_positions: int  # frames or patches
    feature_dim: int = 0  # 0 => d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "hybrid" | "ssm" | "audio" | "vlm" | "recsys"
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendConfig] = None
    # Per-layer pattern tiled over depth: tuple of (mixer, ffn) pairs where
    # mixer in {"attn", "mamba"} and ffn in {"mlp", "moe", "none"}.
    # None => homogeneous ("attn", "mlp"/"moe") stack.
    layer_pattern: Optional[Tuple[Tuple[str, str], ...]] = None
    mlp_type: str = "swiglu"  # "swiglu" | "mlp"
    activation: str = "silu"  # "silu" | "gelu" | "relu2"
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Sub-quadratic sequence mixing available (SSM / hybrid).
    subquadratic: bool = False

    @property
    def layer_plan(self) -> Tuple[Tuple[str, str], ...]:
        """Fully expanded per-layer (mixer, ffn) plan of length n_layers."""
        if self.layer_pattern is not None:
            period = len(self.layer_pattern)
            assert self.n_layers % period == 0, (self.name, self.n_layers, period)
            return tuple(self.layer_pattern[i % period] for i in range(self.n_layers))
        ffn = "moe" if self.moe is not None else "mlp"
        mixer = "mamba" if (self.mamba is not None and self.attention is None) else "attn"
        return tuple((mixer, ffn) for _ in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + dense stack + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        for mixer, ffn in self.layer_plan:
            if mixer == "attn" and self.attention is not None:
                a = self.attention
                qo = d * a.n_heads * a.head_dim * 2
                kv = d * a.n_kv_heads * a.head_dim * 2
                total += qo + kv
            elif mixer == "mamba" and self.mamba is not None:
                m = self.mamba
                d_in = m.expand * d
                nheads = d_in // m.headdim
                conv_dim = d_in + 2 * m.n_groups * m.d_state
                total += d * (2 * d_in + 2 * m.n_groups * m.d_state + nheads)  # in_proj
                total += conv_dim * m.d_conv  # conv
                total += 2 * nheads  # A_log, D
                total += d_in * d  # out_proj
            if ffn == "mlp":
                total += d * f * (3 if self.mlp_type == "swiglu" else 2)
            elif ffn == "moe" and self.moe is not None:
                e = self.moe.num_experts
                total += d * e  # router
                total += e * d * f * (3 if self.mlp_type == "swiglu" else 2)
            total += 2 * d  # norms
        if self.encoder is not None:
            enc_d = self.encoder.d_model or d
            a = self.attention
            per_layer = enc_d * (a.n_heads + a.n_kv_heads) * a.head_dim * 2 + enc_d * f * (
                3 if self.mlp_type == "swiglu" else 2
            ) + 2 * enc_d
            total += self.encoder.n_layers * per_layer
            # decoder cross-attention blocks
            total += self.n_layers * (d * (a.n_heads + a.n_kv_heads) * a.head_dim * 2 + d)
        return total


# ---------------------------------------------------------------------------
# Recsys-side configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SparseTableConfig:
    name: str
    vocab_size: int
    dim: int
    # multi-hot bag size per sample (1 => one-hot feature)
    bag_size: int = 1
    combiner: str = "sum"  # "sum" | "mean"


@dataclass(frozen=True)
class RecsysModelConfig:
    name: str
    backbone: str  # "hstu" | "fuxi" | "dlrm"
    tables: Tuple[SparseTableConfig, ...]
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    seq_len: int  # behaviour-sequence length
    num_dense_features: int = 16
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # Zipf exponent of the synthetic key stream (data/synthetic).
    zipf_a: float = 1.2
    # Non-stationary key streams (data/synthetic): drift rotates the zipf
    # rank->key mapping every step; growth confines sampling to a live
    # prefix that widens every step. Zeros give the stationary stream.
    drift_keys_per_step: int = 0
    growth_keys_per_step: int = 0
    growth_base_keys: int = 0

    @property
    def total_sparse_rows(self) -> int:
        return sum(t.vocab_size for t in self.tables)

    @property
    def max_table_dim(self) -> int:
        return max(t.dim for t in self.tables)


@dataclass(frozen=True)
class NestPipeConfig:
    """The NestPipe switches the serving path and the DBP driver read."""

    fwp_microbatches: int = 4  # N; 1 disables FWP
    clustering: str = "keycentric"  # "keycentric" | "none"
    # Fixed-capacity routing knobs (static shapes).
    unique_capacity_factor: float = 1.0  # U_max = ceil(L * factor)
    bucket_slack: float = 1.5  # C = ceil(U_max / S * slack)
    # Embedding storage tier: "auto" resolves $REPRO_STORE, then "device";
    # "device" | "host" | "cached" force one (core/store).
    store: str = "auto"
    # The cached tier: its device cache in rows (0 = padded_rows // 8), the
    # access count a chunk needs before admission, the chunk (the unit of
    # admission, eviction and host<->device bursts) in rows, and the
    # eviction policy ("auto" resolves $REPRO_CACHE_POLICY, then "freq";
    # core/store/policy.py). None of them changes a value: every setting
    # replays the host tier bit for bit.
    cache_rows: int = 0
    cache_admit: int = 1
    cache_chunk_rows: int = 8
    cache_policy: str = "auto"
    # The host tiers' sparse-path wire mode ("auto" resolves
    # $REPRO_SPARSE_COMM, then "off"): "pack" is lossless and replays "off"
    # bit for bit, "int8" is approximate (core/store/comm.py).
    sparse_comm: str = "auto"
    # DBP lookahead depth k: the Prefetcher routes and retrieves step t+k
    # while step t computes (k=1 is the paper's dual-buffer setting).
    prefetch_ahead: int = 1
    # The async host-stage executor: plan / retrieve on stage threads and
    # the commit on a commit thread, epoch-fenced, the same bits as the
    # synchronous loop (core/store/async_exec.py). "auto" resolves
    # $REPRO_ASYNC_STAGES, then off; "on" | "off" force it.
    async_stages: str = "auto"
    # plan / retrieve threads of the executor (1: one FIFO; more keep the
    # values exact, cache counters may vary from run to run)
    stage_workers: int = 1


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # dense optimizer
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    # Sparse (embedding) optimizer — rowwise to bound state size.
    sparse_name: str = "rowwise_adagrad"
    sparse_lr: float = 0.05
    sparse_eps: float = 1e-8
    # Moment dtype policy: "f32" always; params bf16 + no master copy for huge archs.
    master_copy: bool = True
