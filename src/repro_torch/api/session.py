"""The Session facade, serving subset: one front door to the recsys
serving path.

    from repro_torch.api import Session

    sess = Session.from_arch("dlrm-ctr")          # runs on cuda
    report = sess.serve_embeddings(head="dlrm", max_batch=512,
                                   num_requests=4096, check_exact=True)
    print(report.summary)

``device`` defaults to ``cuda`` and raises without a GPU; pass
``device="cpu"`` for the plain PyTorch path.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.base import NestPipeConfig
from ..core.embedding.table import EmbeddingTableState, init_table_state
from ..launch.build import Workload, resolve
from ..models.dlrm import DLRM
from ..utils import resolve_device
from .strategies import InferenceStrategy


@dataclass
class EmbedServeReport:
    """Per-request results (rid order) + latency summary from an
    embedding-serving run (:meth:`Session.serve_embeddings`)."""

    results: np.ndarray  # (n, F, D) embeddings or (n,) dlrm logits
    summary: Dict[str, Any] = field(default_factory=dict)


class Session:
    """A serving session over one resolved recsys workload.

    The session owns the workload and the weights: the DLRM dense model and
    the master table, drawn on the device from ``seed`` on first use, or
    set by :meth:`ingest` (e.g. weights carried across from the JAX package
    by ``repro_torch.convert``).
    """

    def __init__(self, workload: Workload, *, seed: int = 0,
                 reduced: bool = False):
        self.workload = workload
        self.seed = seed
        self.reduced = reduced
        self.device = workload.device
        self._model: Optional[DLRM] = None
        self._table: Optional[EmbeddingTableState] = None

    @classmethod
    def from_arch(
        cls,
        arch: str,
        *,
        reduced: bool = False,
        bucket_slack: float = 4.0,
        store: str = "auto",
        npcfg: Optional[NestPipeConfig] = None,
        seed: int = 0,
        device: Optional[str | torch.device] = None,
    ) -> "Session":
        """Resolve a registry arch into a ready session on ``device``."""
        device = resolve_device(device)
        npcfg = npcfg or NestPipeConfig(bucket_slack=bucket_slack)
        if store != "auto":
            npcfg = dataclasses.replace(npcfg, store=store)
        wl = resolve(arch, device=device, npcfg=npcfg, reduced=reduced)
        return cls(wl, seed=seed, reduced=reduced)

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------

    def weights(self) -> Tuple[DLRM, EmbeddingTableState]:
        """The (model, table) this session serves; a fresh init from
        ``seed`` on first use."""
        if self._model is None:
            g = torch.Generator(self.device).manual_seed(self.seed)
            self._model = DLRM(self.workload.cfg, device=self.device, generator=g)
            self._table = init_table_state(self.workload.spec,
                                           device=self.device, generator=g)
        return self._model, self._table

    def ingest(self, params: Mapping[str, torch.Tensor],
               table: EmbeddingTableState) -> None:
        """Serve these weights in place of the fresh init: ``params`` is a
        DLRM state dict, ``table`` the master (see ``repro_torch.convert``)."""
        spec = self.workload.spec
        if tuple(table.rows.shape) != (spec.padded_rows, spec.dim):
            raise ValueError(f"table shape {tuple(table.rows.shape)} != "
                             f"({spec.padded_rows}, {spec.dim})")
        if table.rows.device != self.device:
            raise ValueError(f"table on {table.rows.device}, session on "
                             f"{self.device}")
        g = torch.Generator(self.device).manual_seed(self.seed)
        model = DLRM(self.workload.cfg, device=self.device, generator=g)
        model.load_state_dict({k: torch.as_tensor(v, device=self.device)
                               for k, v in params.items()})
        self._model, self._table = model, table

    # ------------------------------------------------------------------
    # serve
    # ------------------------------------------------------------------

    def serve_embeddings(
        self,
        *,
        num_requests: int = 256,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        qps: Optional[float] = None,
        zipf_a: Optional[float] = None,
        head: str = "embedding",
        store: Optional[str] = None,
        check_exact: bool = False,
        seed: Optional[int] = None,
    ) -> EmbedServeReport:
        """Serve a zipf embedding-request stream (the recsys serving path).

        Resolves a serve-shaped workload under the ``serve`` strategy
        (``fwp_microbatches=1``), ingests the
        session's master table into the store tier, freezes it behind a
        :class:`~repro_torch.serve.FrozenStoreView`, and pumps
        ``num_requests`` synthetic zipf requests through a window-coalescing
        :class:`~repro_torch.serve.ServeRouter`.

        ``qps=None`` runs closed-loop (sustained throughput); a positive
        ``qps`` paces arrivals open-loop. ``head`` is ``"embedding"`` (raw
        (F, D) rows per request) or ``"dlrm"`` (one logit per request).
        ``check_exact`` recomputes every result from the master table via
        ``lookup_from_master`` and reports ``exact``/``max_abs_diff``.
        """
        from ..serve import build_router, run_closed_loop, run_open_loop, \
            synthetic_requests

        seed = self.seed if seed is None else seed
        strategy = InferenceStrategy()
        npcfg = self.workload.npcfg
        if store is not None and store != "auto":
            npcfg = dataclasses.replace(npcfg, store=store)
        npcfg = strategy.configure(npcfg)
        wl = resolve(self.workload.arch.name, device=self.device, npcfg=npcfg,
                     reduced=self.reduced, global_batch=max_batch)
        model, table = self.weights()

        view = strategy.build_view(wl, table)
        router = build_router(wl, view, model=model, head=head,
                              max_wait_ms=max_wait_ms)
        requests = synthetic_requests(wl, num_requests, zipf_a=zipf_a,
                                      seed=seed)
        if qps is None:
            summary = run_closed_loop(router, requests)
        else:
            summary = run_open_loop(router, requests, qps)

        results = np.stack([router.results[r] for r in range(num_requests)])
        summary.update({
            "arch": self.workload.arch.name, "store": view.tier,
            "sparse_comm": view.sparse_comm,
            "head": head, "max_batch": max_batch,
            "max_wait_ms": max_wait_ms, "device": str(self.device),
        })
        if check_exact:
            diff = self._serve_ground_truth_diff(
                wl, model, table, requests, results, head)
            summary["max_abs_diff"] = float(diff)
            summary["exact"] = int(diff == 0.0)
        return EmbedServeReport(results=results, summary=summary)

    @staticmethod
    @torch.inference_mode()
    def _serve_ground_truth_diff(wl, model, table, requests, results,
                                 head) -> float:
        """Max |served - lookup_from_master ground truth| over every
        request, chunked at the serve batch shape."""
        engine = wl.engine
        b = wl.batch_shapes["keys"][0][1]
        n = len(requests)
        diff = 0.0
        for lo in range(0, n, b):
            idx = [min(lo + i, n - 1) for i in range(b)]  # pad by repeat
            keys = torch.as_tensor(np.stack([requests[i][0] for i in idx]),
                                   device=engine.device)
            emb, _ = engine.lookup_from_master(table, keys)
            ref = emb.to(engine.compute_dtype)
            if head == "dlrm":
                dense = torch.as_tensor(
                    np.stack([requests[i][1] for i in idx]), device=engine.device)
                ref = model(ref.to(torch.float32), dense)
            ref = ref.cpu().numpy()
            got = results[idx]
            diff = max(diff, float(np.max(np.abs(
                got.astype(np.float64) - ref.astype(np.float64)))))
        return diff
