"""The NestPipe embedding engine, single device (``repro.core.embedding.engine``
with ``mesh=None``).

The serving data path: fixed-capacity key dedup + owner bucketing (DBP
stage 3), owner-side retrieval of master rows into a buffer (stage 4a),
and the FWP forward lookup served from that buffer. With one device there
is one shard, so the key and embedding All2Alls are the identity; the
exchange layout is kept so every plan leaf matches the JAX engine's.

The training ops: the gradient exchange to owners (FWP backward), the
window's sparse update into the active buffer (segment sums + rowwise
Adagrad), the dual-buffer sync (DBP stage 4b), the master write-back
(stage 5'') and the serial baseline's direct master update.

Every row gather, segment sum, buffer sync and write-back goes through
``kernels.dispatch``: the hand-written CUDA kernel on the card, its plain
version on the CPU. A served window runs four gathers (``retrieve``, then
``lookup_from_buffer``: the buffer serve and ``_assemble``'s two),
``lookup_from_master`` three. A training step adds one segment sum per
micro-batch (``grads_to_owner``), one for the window
(``apply_window_to_buffer``), one buffer sync and one write-back.

JAX's ops are pure and its jits donate; the port updates the master in
place in ``writeback`` (the one consumer that must not copy a 29 GB
table) and returns fresh tensors everywhere else.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from ...configs.base import NestPipeConfig
from ...kernels import dispatch
from ...utils import cdiv, round_up
from .routing import (
    SENTINEL,
    bucket_by_owner_window,
    fixed_unique_window,
    intersect_sorted,
    merge_sorted_unique,
    sorted_lookup,
)
from .table import EmbeddingTableState, MegaTableSpec


class LookupPlan(NamedTuple):
    """Routing artifacts for one lookup unit (one micro-batch)."""

    inverse: torch.Tensor  # (L,) position -> unique slot (U for invalid)
    slot_of_unique: torch.Tensor  # (U,) unique slot -> flat send slot (S*C for invalid)
    recv_keys: torch.Tensor  # (S, C) keys this shard must serve (owner side)
    overflow: torch.Tensor  # () int32 routing overflow (must be 0)


class WindowPlan(NamedTuple):
    """Routing for a whole FWP window of N micro-batches (DBP stage 3)."""

    plans: LookupPlan  # leaves stacked along leading N axis
    buffer_keys: torch.Tensor  # (K,) owner-side union of requested keys (sorted)


class GradPacket(NamedTuple):
    """Owner-side gradient fragment produced by one micro-batch's exchange."""

    keys: torch.Tensor  # (S, C) int32
    grads: torch.Tensor  # (S, C, D) f32


class DualBuffer(NamedTuple):
    """Compact owner-side row cache (DBP active / prefetch buffer)."""

    keys: torch.Tensor  # (K,) sorted unique, SENTINEL-padded
    rows: torch.Tensor  # (K, D)
    accum: torch.Tensor  # (K,) rowwise adagrad state


@dataclass(frozen=True)
class EngineDims:
    l_local: int  # flattened local positions per micro-batch
    u_max: int  # unique capacity per micro-batch
    cap: int  # per-destination All2All capacity C
    num_shards: int  # S
    n_micro: int  # N
    buffer_cap: int  # K — owner-side union capacity


def _take_fill(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` along axis 0 with out-of-range -> 0 (a 1-D vector:
    the adagrad state beside the gathered rows)."""
    n = values.shape[0]
    valid = (idx >= 0) & (idx < n)
    got = values[torch.clamp(idx, 0, n - 1).long()]
    return torch.where(valid, got, got.new_zeros(()))


class EmbeddingEngine:
    """Lookup ops for one mega-table on one device."""

    def __init__(
        self,
        spec: MegaTableSpec,
        np_cfg: NestPipeConfig,
        *,
        device: torch.device | str,
        compute_dtype: torch.dtype = torch.bfloat16,
        sparse_lr: float = 0.05,
        sparse_eps: float = 1e-8,
    ):
        self.spec = spec
        self.cfg = np_cfg
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.sparse_lr = float(sparse_lr)
        self.sparse_eps = float(sparse_eps)
        self.num_shards = 1
        self.union_size = 1
        assert spec.num_shards == self.num_shards, (spec.num_shards, self.num_shards)

    def dims(self, keys_shape: Tuple[int, ...], n_micro: int = 1) -> EngineDims:
        """Derive the fixed capacities from the per-micro-batch keys shape."""
        l_local = 1
        for dim in keys_shape:
            l_local *= dim
        u = min(round_up(max(int(l_local * self.cfg.unique_capacity_factor), 8), 8),
                self.spec.padded_rows)
        c = min(round_up(cdiv(int(u * self.cfg.bucket_slack), self.num_shards), 8),
                self.spec.rows_per_shard)
        k = min(self.union_size * n_micro * self.num_shards * c,
                self.spec.rows_per_shard)
        k = round_up(k, 8)
        return EngineDims(l_local, u, c, self.num_shards, n_micro, k)

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------

    def _a2a(self, x: torch.Tensor) -> torch.Tensor:
        """Owner exchange over the leading (S,) axis: the identity on one
        shard (the multi-rank exchange is not ported yet)."""
        assert self.num_shards == 1
        return x

    def _route_plans(self, kf: torch.Tensor, dims: EngineDims) -> LookupPlan:
        """Fused routing for an (N, L) key block: one window-wide dedup +
        owner bucketing pass and one key exchange for all N units."""
        n = kf.shape[0]
        uniq = fixed_unique_window(kf, dims.u_max)
        buck = bucket_by_owner_window(
            uniq.unique_keys, dims.num_shards, dims.cap, self.spec.rows_per_shard)
        send = buck.send_keys.movedim(0, 1).reshape(dims.num_shards, n * dims.cap)
        recv = self._a2a(send).reshape(dims.num_shards, n, dims.cap)
        return LookupPlan(
            inverse=uniq.inverse,
            slot_of_unique=buck.slot_of_unique,
            recv_keys=recv.movedim(1, 0).contiguous(),  # (N, S, C)
            overflow=(uniq.overflow + buck.overflow)[:, None],  # (N, 1)
        )

    def _route_one(self, keys_flat: torch.Tensor, dims: EngineDims) -> LookupPlan:
        """Single lookup unit: the N=1 view of the fused window route."""
        plans = self._route_plans(keys_flat[None], dims)
        return LookupPlan(*(x[0] for x in plans))

    def _serve_rows(self, rows_src: torch.Tensor, local_idx: torch.Tensor,
                    shape: Tuple[int, ...]) -> torch.Tensor:
        served = dispatch.gather_rows(rows_src, local_idx.reshape(-1))
        return served.reshape(*shape, rows_src.shape[-1]).to(self.compute_dtype)

    def _master_local_idx(self, recv_keys: torch.Tensor) -> torch.Tensor:
        shard_id = 0
        valid = recv_keys != SENTINEL
        return torch.where(valid, recv_keys - shard_id * self.spec.rows_per_shard,
                           self.spec.rows_per_shard)

    def _assemble(self, plan: LookupPlan, served: torch.Tensor) -> torch.Tensor:
        back = self._a2a(served)  # (S, C, D)
        flat = back.reshape(-1, back.shape[-1])
        unique_emb = dispatch.gather_rows(flat, plan.slot_of_unique)
        return dispatch.gather_rows(unique_emb, plan.inverse)  # (L, D)

    def _grads_out(self, plan: LookupPlan, demb: torch.Tensor,
                   dims: EngineDims) -> GradPacket:
        """Source-side segment sum to uniques + gradient exchange to owners."""
        d = demb.shape[-1]
        uniq_grads = dispatch.segment_rowsum(demb, plan.inverse, dims.u_max)
        flat_sc = dims.num_shards * dims.cap
        # slot S*C (overflowed uniques) lands in a spare row, sliced off
        send = torch.zeros((flat_sc + 1, d), dtype=torch.float32, device=demb.device)
        send.index_copy_(0, plan.slot_of_unique.long(), uniq_grads)
        recv = self._a2a(send[:flat_sc].reshape(dims.num_shards, dims.cap, d))
        return GradPacket(keys=plan.recv_keys, grads=recv)

    def _window_grads_to_buffer_space(self, buffer_keys: torch.Tensor,
                                      packets: GradPacket) -> torch.Tensor:
        """Segment all window packets into buffer space (K, D) f32."""
        flat_keys = packets.keys.reshape(-1)
        flat_grads = packets.grads.reshape(-1, packets.grads.shape[-1])
        idx = sorted_lookup(buffer_keys, flat_keys)
        return dispatch.segment_rowsum(flat_grads, idx, buffer_keys.shape[0])

    def _rowwise_adagrad(self, rows, accum, total, touched):
        new_accum = accum + torch.where(touched, (total * total).mean(-1),
                                        total.new_zeros(()))
        # a true division (``float / tensor`` would multiply by a reciprocal),
        # by a tensor filled on the device: a tensor made from a Python float
        # is a copy from the host, which syncs the stream
        lr = torch.full((), self.sparse_lr, dtype=total.dtype, device=total.device)
        scale = lr / (torch.sqrt(torch.clamp(new_accum, min=0.0)) + self.sparse_eps)
        scale = torch.where(touched, scale, scale.new_zeros(()))[:, None]
        # rows - scale * total as one fused multiply-add, as XLA computes it
        return torch.addcmul(rows, scale, total, value=-1).to(rows.dtype), new_accum

    # ------------------------------------------------------------------
    # public ops
    # ------------------------------------------------------------------

    def route_window(self, keys: torch.Tensor, n_micro: int) -> WindowPlan:
        """DBP stage 3 for a whole window. ``keys``: (N, *batch_shape)."""
        dims = self.dims(tuple(keys.shape[1:]), n_micro)
        plans = self._route_plans(keys.reshape(dims.n_micro, -1), dims)
        buffer_keys = merge_sorted_unique(plans.recv_keys.reshape(-1),
                                          dims.buffer_cap)
        return WindowPlan(plans, buffer_keys)

    def retrieve(self, table: EmbeddingTableState, window: WindowPlan) -> DualBuffer:
        """DBP stage 4a: gather master rows + adagrad state into a fresh
        buffer."""
        bkeys = window.buffer_keys
        local_idx = self._master_local_idx(bkeys)
        brows = self._serve_rows(table.rows, local_idx, (bkeys.shape[0],))
        baccum = _take_fill(table.accum, local_idx)
        return DualBuffer(bkeys, brows.to(table.rows.dtype), baccum)

    def sync_buffers(self, active: DualBuffer, prefetch: DualBuffer) -> DualBuffer:
        """DBP stage 4b: rows (and adagrad state) of the *active* buffer,
        just updated by batch t, overwrite the matching rows of the
        *prefetch* buffer serving batch t+1: the paper's
        K(B_t) ∩ K(B_t+1) copy (Prop. 1). Returns a fresh buffer; neither
        input is written."""
        idx = intersect_sorted(active.keys, prefetch.keys)  # slot in active or K_a
        rows, accum = dispatch.buffer_sync(active.rows, active.accum,
                                           prefetch.rows, prefetch.accum, idx)
        return DualBuffer(prefetch.keys, rows, accum)

    def lookup_from_buffer(
        self, buffer: DualBuffer, plan: LookupPlan, keys_shape: Tuple[int, ...],
        n_micro: int,
    ) -> torch.Tensor:
        """FWP forward for one micro-batch served from the buffer. Returns
        embeddings (*keys_shape, D)."""
        idx = sorted_lookup(buffer.keys, plan.recv_keys.reshape(-1))
        served = self._serve_rows(buffer.rows, idx, tuple(plan.recv_keys.shape))
        emb = self._assemble(plan, served)
        return emb.reshape(*keys_shape, -1)

    def lookup_from_master(
        self, table: EmbeddingTableState, keys: torch.Tensor
    ) -> Tuple[torch.Tensor, LookupPlan]:
        """Lookup straight from the master table (the serial baseline; the
        ground truth serving is checked against)."""
        dims = self.dims(tuple(keys.shape), 1)
        plan = self._route_one(keys.reshape(-1), dims)
        local_idx = self._master_local_idx(plan.recv_keys)
        served = self._serve_rows(table.rows, local_idx, tuple(plan.recv_keys.shape))
        emb = self._assemble(plan, served)
        return emb.reshape(*keys.shape, -1), plan

    def grads_to_owner(self, plan: LookupPlan, demb: torch.Tensor,
                       keys_shape: Tuple[int, ...], n_micro: int) -> GradPacket:
        """FWP backward for one micro-batch: gradient exchange to owners."""
        dims = self.dims(keys_shape, n_micro)
        flat = demb.reshape(-1, demb.shape[-1]).to(torch.float32).contiguous()
        return self._grads_out(plan, flat, dims)

    def apply_window_to_buffer(self, buffer: DualBuffer,
                               packets: GradPacket) -> DualBuffer:
        """Frozen-window end: aggregate all N packets by key and apply
        rowwise adagrad once to the active buffer. ``packets`` leaves are
        stacked (N, ...). Returns a fresh buffer."""
        total = self._window_grads_to_buffer_space(buffer.keys, packets)
        # a zero grad row counts as untouched; that only skips an update
        # that would be a no-op anyway
        touched = (total != 0.0).any(-1)
        rows, accum = self._rowwise_adagrad(buffer.rows, buffer.accum, total,
                                            touched)
        return DualBuffer(buffer.keys, rows, accum)

    def writeback(self, table: EmbeddingTableState,
                  buffer: DualBuffer) -> EmbeddingTableState:
        """DBP stage 5'': write the updated buffer's rows and adagrad state
        into the master, IN PLACE (the JAX jit donates the table instead).
        Sentinel slots are dropped inside the kernel, so there is no device
        sync. Returns ``table`` itself."""
        local_idx = self._master_local_idx(buffer.keys)
        dispatch.scatter_rows(table.rows, table.accum, local_idx,
                              buffer.rows.to(table.rows.dtype), buffer.accum)
        return table

    def apply_packets_to_master(self, table: EmbeddingTableState,
                                packets: GradPacket) -> EmbeddingTableState:
        """Serial-mode update: window packets -> master row space -> rowwise
        adagrad. Allocates (Vp, D) temporaries, so it runs at small sizes
        only (the full dlrm-ctr master does not fit twice). Returns a fresh
        table."""
        local_idx = self._master_local_idx(packets.keys).reshape(-1)
        flat = packets.grads.reshape(-1, packets.grads.shape[-1])
        total = dispatch.segment_rowsum(flat, local_idx, self.spec.rows_per_shard)
        touched = (total != 0.0).any(-1)
        rows, accum = self._rowwise_adagrad(table.rows, table.accum, total, touched)
        return EmbeddingTableState(rows, accum)

    def overflow_metric(self, plan_or_window) -> torch.Tensor:
        """Max routing overflow (must stay 0)."""
        ovf = (plan_or_window.plans.overflow
               if isinstance(plan_or_window, WindowPlan)
               else plan_or_window.overflow)
        return ovf.max()
