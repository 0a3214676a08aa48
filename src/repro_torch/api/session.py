"""The Session facade: one front door to training and serving a workload
(``repro.api.session``, device tier, one card).

    from repro_torch.api import Session

    sess = Session.from_arch("dlrm-ctr", mode="nestpipe", global_batch=8192,
                             bucket_slack=1.5)         # runs on cuda
    report = sess.train(8)
    print(report.summary)
    served = sess.serve_embeddings(head="dlrm", max_batch=512,
                                   num_requests=4096, check_exact=True)

    lm = Session.from_arch("stablelm-12b")             # a dense LM
    print(lm.serve(batch=8, prompt_len=2048, gen=32).summary)
    lm3 = Session.from_arch("stablelm-3b", global_batch=8, seq_len=4096, lr=3e-5)
    print(lm3.train(4).summary)                        # then .serve() serves it
    wb = Session.from_arch("whisper-base", global_batch=256, seq_len=448,
                           bucket_slack=1.5, lr=3e-5)  # an encoder-decoder
    print(wb.train(4).summary, wb.serve(batch=16, prompt_len=416, gen=32).summary)
    px = Session.from_arch("pixtral-12b")               # a VLM: patches, then text
    print(px.serve(batch=8, prompt_len=2048, gen=32).summary)

Training runs any ported recsys backbone (DLRM, HSTU, FuXi), dense LM,
VLM (whose windows carry stub patches) or encoder-decoder (whose windows
carry stub audio frames) and checkpoints
it (``ckpt_dir``, ``ckpt_every``; :meth:`Session.save`,
:meth:`Session.restore`, :meth:`Session.restore_if_available`,
``train(resume=True)``), under the session's fault policy: a preemption
guard (``preemption_signals``) the driver polls at step boundaries, saving
before it exits, a step watchdog (``watchdog_factor``) and the fault
injector of ``fault_inject`` (``repro_torch.dist``). Recsys serving has a
DLRM head only, as in the JAX package. A dense LM trains (next-token
cross-entropy over the FWP window) and serves (batched prefill, then
greedy KV-cache decode), the trained weights once it trained. A config
outside the registry goes through ``launch.build.assemble_workload`` and
:meth:`Session.from_workload`. ``device`` defaults to ``cuda`` and raises
without a GPU; pass ``device="cpu"`` for the plain PyTorch path.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.base import NestPipeConfig, OptimizerConfig
from ..core.dbp.pipeline import PipelineStats
from ..core.embedding.table import EmbeddingTableState, init_table_state
from ..dist.checkpoint import (
    latest_step,
    restore_checkpoint,
    restore_latest_verifiable,
    save_checkpoint,
)
from ..dist.fault import PreemptionGuard, StepWatchdog
from ..dist.inject import FaultInjector, resolve_fault_inject
from ..launch.build import Workload, resolve
from ..models.dlrm import DLRM
from ..models.frontend import frontend_embed_shape
from ..train.state import TrainState
from ..utils import resolve_device, same_device
from .strategies import get_strategy
from .streams import resolve_stream


@dataclass
class TrainReport:
    """What a train run produced: final state + pipeline statistics."""

    state: TrainState
    stats: PipelineStats
    wall_s: float
    stragglers: int
    summary: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EmbedServeReport:
    """Per-request results (rid order) + latency summary from an
    embedding-serving run (:meth:`Session.serve_embeddings`)."""

    results: np.ndarray  # (n, F, D) embeddings or (n,) dlrm logits
    summary: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ServeReport:
    """Generated tokens (B, gen) + timing summary from :meth:`Session.serve`."""

    tokens: np.ndarray
    summary: Dict[str, Any] = field(default_factory=dict)


class Session:
    """A training/serving session over one resolved workload.

    The session owns the workload, the execution strategy and the train
    state (dense params, optimizer state, master table, step): drawn on the
    device from ``seed`` on first use, replaced by :meth:`ingest` (weights
    from elsewhere, fresh optimizer state), by assigning ``state`` (e.g.
    a JAX train state carried over by ``repro_torch.convert``) or by a
    restore from ``ckpt_dir``. Training reads the stream drawn from
    ``data_seed`` (default: ``seed``) from batch index ``state.step``, so a
    restored session, whatever its init seed, resumes the run it came
    from; it saves every ``ckpt_every`` steps when ``ckpt_dir`` is set.
    Training updates the master in place; serving reads the current
    weights.

    The fault policy is the session's too: ``guard`` (a
    ``PreemptionGuard`` on ``preemption_signals``; none by default, and
    ``guard.restore()`` gives the signals back), ``watchdog`` (a
    ``StepWatchdog`` at ``watchdog_factor``) and ``ckpt_injector``, built
    from the config's resolved ``fault_inject`` apart from the store's, so
    its ``ckpt_torn`` / ``ckpt_corrupt`` schedules count saves.

    A dense LM session that has no train state serves without one:
    :meth:`serve` draws the params and the master table only (no
    optimizer moments), from the seed, once per seed, unless :meth:`ingest`
    handed it weights; the train state (first used by ``state`` or
    :meth:`train`) starts from those ingested weights, or draws its own,
    and once it exists :meth:`serve` serves it.
    """

    def __init__(self, workload: Workload, *, opt_cfg: Optional[OptimizerConfig] = None,
                 seed: int = 0, data_seed: Optional[int] = None,
                 ckpt_dir: str = "", ckpt_every: int = 0, strategy=None,
                 watchdog_factor: float = 3.0, preemption_signals: tuple = (),
                 reduced: bool = False):
        self.workload = workload
        self.strategy = strategy or get_strategy(workload.mode)
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.seed = seed  # draws the weights
        self.data_seed = seed if data_seed is None else data_seed  # the stream
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.reduced = reduced
        self.device = workload.device
        self.guard = PreemptionGuard(signals=preemption_signals)
        self.watchdog = StepWatchdog(factor=watchdog_factor)
        self.ckpt_injector = FaultInjector.from_spec(
            resolve_fault_inject(workload.npcfg.fault_inject))
        self._fns = None
        self._optimizer = None
        self._state: Optional[TrainState] = None
        self._state_taken = False  # a train run holds the state
        self._model: Optional[DLRM] = None
        self._model_of: Optional[Dict[str, torch.Tensor]] = None
        # LM weights: (seed they were drawn from, or None if ingested,
        # params, table)
        self._lm: Optional[Tuple[Optional[int], Dict[str, torch.Tensor],
                                 EmbeddingTableState]] = None

    @classmethod
    def from_arch(
        cls,
        arch: str,
        *,
        mode: str = "nestpipe",
        reduced: bool = False,
        global_batch: Optional[int] = None,
        seq_len: Optional[int] = None,
        n_micro: int = 4,
        clustering: str = "keycentric",
        bucket_slack: float = 4.0,
        store: str = "auto",
        cache_rows: int = 0,
        cache_chunk_rows: int = 0,
        cache_policy: str = "auto",
        prefetch_ahead: int = 1,
        sparse_comm: str = "auto",
        async_stages: str = "auto",
        stage_workers: int = 1,
        fault_inject: str = "auto",
        t_chunk: int = 64,
        npcfg: Optional[NestPipeConfig] = None,
        opt_cfg: Optional[OptimizerConfig] = None,
        lr: Optional[float] = None,
        seed: int = 0,
        data_seed: Optional[int] = None,
        ckpt_dir: str = "",
        ckpt_every: int = 0,
        preemption_signals: tuple = (),
        device: Optional[str | torch.device] = None,
    ) -> "Session":
        """Resolve a registry arch into a ready session on ``device``.

        ``mode`` names a registered strategy (``nestpipe | async | serial |
        serve``). ``global_batch`` is the training batch (a recsys arch's
        default 65,536, the JAX package's recsys batch), split into
        ``n_micro`` FWP micro-batches. A dense LM trains on ``global_batch``
        sequences of ``seq_len`` tokens (JAX's ``train_4k``, 256 x 4,096,
        when neither is given, else 32 for the one left out), its
        cross-entropy chunked over ``t_chunk`` positions. ``bucket_slack``
        sizes the routing buffers (C and K): 4.0 only pads them on one
        shard, 1.5 is the ``NestPipeConfig`` default. ``prefetch_ahead`` is
        the DBP lookahead depth k.

        ``store`` picks the embedding tier for the pipelined modes
        (``"device" | "host" | "cached"``; ``"auto"`` resolves
        ``$REPRO_STORE``, then the device tier). ``cache_rows`` sizes the
        cached tier's device cache (0: the config's, ``padded_rows // 8``
        by default), ``cache_chunk_rows`` its chunk (0: the config's, 8)
        and ``cache_policy`` its eviction policy (``"freq" | "lfu" | "lru" |
        "oracle"``; ``"auto"`` resolves ``$REPRO_CACHE_POLICY``, then
        ``"freq"``). Every tier and policy replays the device tier's
        trajectory bit for bit.

        ``sparse_comm`` is the host tiers' sparse-path wire mode (``"off" |
        "pack" | "int8"``; ``"auto"`` resolves ``$REPRO_SPARSE_COMM``, then
        off): ``pack`` replays ``off`` bit for bit, ``int8`` is approximate.
        ``async_stages`` runs the host-side plan / retrieve / commit stages
        on worker threads, the same bits as without (``"auto"`` resolves
        ``$REPRO_ASYNC_STAGES``, then off), and ``stage_workers`` sizes its
        plan / retrieve pool.

        ``fault_inject`` arms deterministic fault injection at the host
        stores' stage boundaries and the checkpoint writer (a schedule such
        as ``"retrieve:step=1;commit:step=3"``, ``dist/inject.py``;
        ``"auto"`` resolves ``$REPRO_FAULT_INJECT``, then off). The stores'
        bounded retries absorb the stage faults: the run replays the
        fault-free trajectory bit for bit, and the summary counts
        ``faults_injected``, ``stage_retries`` and ``commit_rollbacks``.
        ``preemption_signals`` (e.g. ``(signal.SIGTERM,)``) install the
        session's preemption guard: a signal makes the run save at the next
        step boundary and return.

        ``seed`` draws the weights, ``data_seed`` (default: ``seed``) the
        batch stream. ``ckpt_dir`` is where :meth:`save` and
        :meth:`restore` write and read, and ``ckpt_every`` (with a
        ``ckpt_dir``) saves every that many steps of a run."""
        strategy = get_strategy(mode)  # fail fast on unknown modes
        device = resolve_device(device)
        npcfg = npcfg or NestPipeConfig(fwp_microbatches=n_micro,
                                        bucket_slack=bucket_slack,
                                        clustering=clustering)
        overlay = {}
        if store != "auto":
            overlay["store"] = store
        if cache_rows != 0:
            overlay["cache_rows"] = cache_rows
        if cache_chunk_rows != 0:
            overlay["cache_chunk_rows"] = cache_chunk_rows
        if cache_policy != "auto":
            overlay["cache_policy"] = cache_policy
        if prefetch_ahead != 1:
            overlay["prefetch_ahead"] = prefetch_ahead
        if sparse_comm != "auto":
            overlay["sparse_comm"] = sparse_comm
        if async_stages != "auto":
            overlay["async_stages"] = async_stages
        if stage_workers != 1:
            overlay["stage_workers"] = stage_workers
        if fault_inject != "auto":
            overlay["fault_inject"] = fault_inject
        if overlay:
            npcfg = dataclasses.replace(npcfg, **overlay)
        npcfg = strategy.configure(npcfg)
        wl = resolve(arch, device=device, mode=mode, npcfg=npcfg, reduced=reduced,
                     global_batch=global_batch, seq_len=seq_len, t_chunk=t_chunk)
        if lr is not None:
            opt_cfg = dataclasses.replace(opt_cfg or OptimizerConfig(), lr=lr)
        return cls(wl, opt_cfg=opt_cfg, seed=seed, data_seed=data_seed,
                   ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, strategy=strategy,
                   preemption_signals=preemption_signals, reduced=reduced)

    @classmethod
    def from_workload(cls, workload: Workload, **kwargs) -> "Session":
        """Wrap a hand-assembled Workload (a config outside the registry,
        e.g. ``hstu-industrial`` with its vocabularies cut to fit one card).
        ``kwargs`` are the constructor's (``opt_cfg``, ``seed``, ...)."""
        return cls(workload, **kwargs)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    @property
    def fns(self):
        if self._fns is None:
            self._fns, self._optimizer = self.workload.step_fns(self.opt_cfg)
        return self._fns

    @property
    def optimizer(self):
        self.fns  # build the (fns, optimizer) pair lazily together
        return self._optimizer

    @property
    def is_lm(self) -> bool:
        """An LM or an encoder-decoder: trained on token windows, served by
        prefill and KV-cache decode."""
        return self.workload.arch.kind in ("lm", "encdec")

    @property
    def state(self) -> TrainState:
        """The train state; on first use a fresh init from ``seed``, or, for
        an LM session that :meth:`ingest` handed weights, those weights with
        a fresh optimizer state at step 0."""
        if self._state is None:
            if self._state_taken:
                raise RuntimeError("the train state went to a train run that "
                                   "failed: it cannot be recovered")
            if self._lm is not None and self._lm[0] is None:  # ingested LM weights
                _, params, table = self._lm
                self._state = TrainState(
                    params, self.optimizer.init(params), table,
                    torch.zeros((), dtype=torch.int32, device=self.device))
            else:
                g = torch.Generator(self.device).manual_seed(self.seed)
                self._state = self.workload.init_state(g, self.optimizer)
            self._lm = None  # serving reads the state from now on
        return self._state

    @state.setter
    def state(self, value: TrainState) -> None:
        self._check_table(value.table)
        self._state, self._state_taken, self._lm = value, False, None

    def _check_table(self, table: EmbeddingTableState) -> None:
        spec = self.workload.spec
        if tuple(table.rows.shape) != (spec.padded_rows, spec.dim):
            raise ValueError(f"table shape {tuple(table.rows.shape)} != "
                             f"({spec.padded_rows}, {spec.dim})")
        if not same_device(table.rows.device, self.device):
            raise ValueError(f"table on {table.rows.device}, session on "
                             f"{self.device}")

    def weights(self) -> Tuple[DLRM, EmbeddingTableState]:
        """The (model, table) the session serves: the current state's dense
        params in a DLRM module, and its master table (not copied)."""
        self._check_serves()
        state = self.state
        if self._model is None or self._model_of is not state.dense:
            g = torch.Generator(self.device).manual_seed(self.seed)
            model = DLRM(self.workload.cfg, device=self.device, generator=g)
            model.load_state_dict(state.dense)
            self._model, self._model_of = model, state.dense
        return self._model, state.table

    def _check_serves(self) -> None:
        if self.is_lm:
            raise ValueError(f"{self.workload.arch.name} is an LM arch: serve it "
                             "with .serve() (prefill + KV-cache decode)")
        backbone = self.workload.cfg.backbone
        if backbone != "dlrm":
            raise NotImplementedError(
                f"serving has a DLRM head only; {self.workload.arch.name!r} is "
                f"a {backbone!r} model (the JAX package has no {backbone} "
                f"serving head either)")

    def ingest(self, params: Mapping[str, torch.Tensor],
               table: EmbeddingTableState) -> None:
        """Use these weights in place of the fresh init, with a fresh
        optimizer state at step 0: ``params`` is the dense model's state
        dict, ``table`` the master (see ``repro_torch.convert``). An LM
        session takes its params (names and shapes checked, dtypes kept)
        and table as they are and builds the optimizer state only when it
        trains (``state``), so a serving session holds no moments."""
        self._check_table(table)
        dense = {k: torch.as_tensor(v, device=self.device).detach()
                 for k, v in params.items()}
        if self.is_lm:
            self._check_lm_params(dense)
            self._lm = (None, dense, table)
            self._state, self._state_taken = None, False
            return
        self._state = TrainState(
            dense, self.optimizer.init(dense), table,
            torch.zeros((), dtype=torch.int32, device=self.device))
        self._state_taken = False

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save(self, step: Optional[int] = None) -> str:
        """Checkpoint the current state under ``ckpt_dir`` (an atomic
        manifest write; ``repro_torch.dist.checkpoint``) at ``step``
        (default: ``state.step``); returns its directory."""
        if not self.ckpt_dir:
            raise ValueError("Session has no ckpt_dir configured")
        s = int(self.state.step) if step is None else int(step)
        return save_checkpoint(self.ckpt_dir, self.state, s)

    def restore(self, step: Optional[int] = None) -> TrainState:
        """Restore the state from ``ckpt_dir`` (the latest step by default)
        into the current state's tensors, in place; the next ``train()``
        resumes the stream at batch index ``state.step``. A restore that
        raises leaves the state as it was."""
        if not self.ckpt_dir:
            raise ValueError("Session has no ckpt_dir configured")
        return self._restored(restore_checkpoint(self.ckpt_dir, self.state, step))

    def restore_if_available(self) -> Optional[int]:
        """Restore the newest checkpoint that verifies (manifest structure
        and every leaf's CRC32) when one exists; returns its step, or None
        when ``ckpt_dir`` holds nothing usable. Damaged checkpoints (a torn
        write, bit rot) are walked past: falling back a step is safe,
        because the trajectory is deterministic."""
        if not self.ckpt_dir or latest_step(self.ckpt_dir) is None:
            return None
        try:
            state, step = restore_latest_verifiable(self.ckpt_dir, self.state)
        except FileNotFoundError:
            return None
        self._restored(state)
        return step

    def _restored(self, state: TrainState) -> TrainState:
        self._state, self._state_taken = state, False
        self._model = self._model_of = None  # weights() rebuilds from it
        return state

    # ------------------------------------------------------------------
    # train
    # ------------------------------------------------------------------

    def train(self, steps: int, *, resume: bool = False,
              checkpoint_final: bool = False) -> TrainReport:
        """Run ``steps`` training steps from the current state. The stream
        (drawn from ``data_seed``) starts at batch index ``state.step``.
        The master table is updated in place; ``self.state`` is rebound to
        the returned state.

        With ``ckpt_dir`` set, the run saves every ``ckpt_every`` steps
        through the driver's checkpoint seam (at the state's own step) and,
        with ``checkpoint_final``, once more at the end. ``resume`` first
        restores the newest verifiable checkpoint, if there is one.

        The driver polls ``guard`` at every step boundary: on a notice it
        saves through the same seam and returns early
        (``stats.preempted_at``); a notice that landed after the last
        boundary saves here. ``watchdog`` sees every step's time, and
        ``stragglers_flagged`` counts its events of this run."""
        if resume:
            self.restore_if_available()
        start = int(self.state.step)
        stream = resolve_stream(self.workload, self.data_seed, start_step=start)

        def on_ckpt(state, _steps_done):
            save_checkpoint(self.ckpt_dir, state, int(state.step),
                            injector=self.ckpt_injector)

        driver = self.strategy.build_driver(
            self.fns, stream, self.workload,
            on_checkpoint=on_ckpt if self.ckpt_dir else None,
            ckpt_every=self.ckpt_every if self.ckpt_dir else 0,
            guard=self.guard, watchdog=self.watchdog)
        events_before = len(self.watchdog.events)
        t0 = time.perf_counter()
        # the run takes the state over (as a JAX run takes it donated): no
        # reference stays here, so a host tier frees the device master
        # once it holds the host copy
        state, stats = driver.run(self._take_state(), max(int(steps), 0))
        wall = time.perf_counter() - t0
        self._state, self._state_taken = state, False
        flagged = len(self.watchdog.events) - events_before
        if self.ckpt_dir and stats.preempted_at is None \
                and (checkpoint_final or self.guard.should_checkpoint):
            # a preempted run saved on its way out; this is checkpoint_final
            # or a notice after the last step boundary
            self.save()
        summary = stats.summary()
        gb = self.workload.global_batch
        samples_per_s = gb * len(stats.step_times) / max(wall, 1e-9)
        summary.update({
            "arch": self.workload.arch.name,
            "mode": self.strategy.name,
            "global_batch": gb,
            "n_micro": self.workload.n_micro,
            "device": str(self.device),
            "wall_s": wall,
            "qps": samples_per_s,
            "samples_per_s": samples_per_s,
            "stragglers_flagged": flagged,
        })
        if self.is_lm:
            seq_len = self.workload.batch_shapes["labels"][0][2]  # a VLM's patches too
            summary.update(seq_len=seq_len, tokens_per_s=samples_per_s * seq_len)
        return TrainReport(state=state, stats=stats, wall_s=wall,
                           stragglers=flagged, summary=summary)

    def _take_state(self) -> TrainState:
        state, self._state = self.state, None
        self._state_taken = True
        return state

    # ------------------------------------------------------------------
    # serve
    # ------------------------------------------------------------------

    def _check_lm_params(self, params: Mapping[str, torch.Tensor]) -> None:
        want = self.workload.bundle.init_params(None, "meta")
        got = {k: tuple(v.shape) for k, v in params.items()}
        if got != {k: tuple(v.shape) for k, v in want.items()}:
            raise ValueError(f"LM params do not match {self.workload.cfg.name}: "
                             f"{sorted(set(got) ^ set(want)) or 'shapes differ'}")

    def lm_weights(self, seed: Optional[int] = None
                   ) -> Tuple[Dict[str, torch.Tensor], EmbeddingTableState]:
        """The (params, master table) an LM session serves: its train
        state's (trained, or the state's first draw), as JAX's serve
        serves a trained session's; else the ingested ones, or a fresh
        init from ``seed`` (default: the session's) for the params and from
        seed 1 for the table, as JAX's serve draws them, kept for the next
        call with the same seed."""
        if self._state is not None:
            return self._state.dense, self._state.table
        seed = self.seed if seed is None else seed
        if self._lm is None or self._lm[0] not in (None, seed):
            self._lm = None  # release the old draw before the new one
            wl = self.workload
            params = wl.bundle.init_params(
                torch.Generator(self.device).manual_seed(seed), self.device)
            table = init_table_state(wl.spec, device=self.device,
                                     generator=torch.Generator(self.device).manual_seed(1))
            self._lm = (seed, params, table)
        return self._lm[1], self._lm[2]

    @torch.inference_mode()
    def serve(self, *, batch: int = 4, prompt_len: int = 16, gen: int = 8,
              seed: Optional[int] = None) -> ServeReport:
        """Batched prefill + greedy KV-cache decode through the embedding
        engine (the LM serving path of ``repro.api.session.Session.serve``).

        Draws ``batch`` prompts of ``prompt_len`` tokens from
        ``np.random.default_rng(seed)`` (an encoder-decoder's stub frames or
        a VLM's stub patches next, from the same rng, as normals times 0.02
        in f32, on the device before the timer starts, as in JAX), scrambles
        them into master rows, looks them up from the master, runs the
        prefill into a cache of ``prompt_len + gen`` positions and takes the
        argmax, then ``gen - 1`` decode steps, each looking up the scrambled
        last token. Recsys archs serve through :meth:`serve_embeddings`.

        A VLM's prefill runs over the patches, then the prompt, and its
        cache holds ``n_positions + prompt_len + gen`` positions. JAX's
        serve sizes it ``prompt_len + gen``: its prefill then raises when
        ``gen < n_positions``, and otherwise its decode writes past the
        cache's end, where the writes clamp onto the last slot."""
        if not self.is_lm:
            raise ValueError(
                f"{self.workload.arch.name} is a recsys arch: no KV-cache "
                "decode path to serve (use .serve_embeddings())")
        if gen < 1 or prompt_len < 1 or batch < 1:
            raise ValueError("serve needs batch, prompt_len and gen of at least 1")
        seed = self.seed if seed is None else seed
        max_len = prompt_len + gen
        wl = self.workload
        cfg, bundle, engine, spec = wl.cfg, wl.bundle, wl.engine, wl.spec
        params, table = self.lm_weights(seed)
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))
        keys = spec.scramble(torch.as_tensor(toks.astype(np.int32), device=self.device))
        extras, patches = {}, None
        if wl.arch.kind == "encdec":
            shape = wl.batch_shapes["frames"][0][2:]
            extras["frames"] = torch.as_tensor(
                rng.normal(size=(batch, *shape)).astype(np.float32) * 0.02,
                device=self.device)
        elif cfg.frontend is not None:  # a VLM: the patches ahead of the prompt
            patches = torch.as_tensor(
                rng.normal(size=frontend_embed_shape(cfg, batch)).astype(np.float32) * 0.02,
                device=self.device)
            max_len += cfg.frontend.n_positions

        t0 = time.perf_counter()
        emb, _ = engine.lookup_from_master(table, keys)
        if patches is not None:
            emb = torch.cat([patches.to(emb.dtype), emb], dim=1)
        logits, cache = bundle.prefill(params, emb, cache_len=max_len, **extras)
        next_tok = logits.argmax(-1).to(torch.int32)
        generated = [next_tok.cpu().numpy()]  # waits for the device
        t_prefill = time.perf_counter() - t0

        t1 = time.perf_counter()
        for _ in range(gen - 1):
            emb, _ = engine.lookup_from_master(table, spec.scramble(next_tok[:, None]))
            logits, cache = bundle.decode_step(params, emb, cache)
            next_tok = logits.argmax(-1).to(torch.int32)
            generated.append(next_tok.cpu().numpy())
        t_decode = time.perf_counter() - t1

        out = np.stack(generated, axis=1)
        summary = {
            "arch": self.workload.arch.name, "batch": batch,
            "prompt_len": prompt_len, "generated": gen,
            "prefill_s": t_prefill, "decode_s": t_decode,
            "tokens_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
            "sample_tokens": out[0, :8].tolist(), "device": str(self.device),
        }
        return ServeReport(tokens=out, summary=summary)

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
        sparse_comm: Optional[str] = None,
        check_exact: bool = False,
        seed: Optional[int] = None,
    ) -> EmbedServeReport:
        """Serve a zipf embedding-request stream (the recsys serving path).

        Resolves a serve-shaped workload under the ``serve`` strategy
        (``fwp_microbatches=1``), ingests the session's current master
        table (trained, if the session trained; the serve workload has the
        same table spec) into the store tier, freezes it behind a
        :class:`~repro_torch.serve.FrozenStoreView`, and pumps
        ``num_requests`` synthetic zipf requests through a window-coalescing
        :class:`~repro_torch.serve.ServeRouter`.

        ``qps=None`` runs closed-loop (sustained throughput); a positive
        ``qps`` paces arrivals open-loop. ``head`` is ``"embedding"`` (raw
        (F, D) rows per request) or ``"dlrm"`` (one logit per request).
        ``check_exact`` recomputes every result from the master table via
        ``lookup_from_master`` and reports ``exact``/``max_abs_diff``.
        ``store`` and ``sparse_comm`` override the session's tier and wire
        mode for the read path (``"pack"`` keeps serving exact).
        """
        from ..serve import build_router, run_closed_loop, run_open_loop, \
            synthetic_requests

        self._check_serves()
        seed = self.seed if seed is None else seed
        strategy = get_strategy("serve")
        npcfg = self.workload.npcfg
        if store is not None and store != "auto":
            npcfg = dataclasses.replace(npcfg, store=store)
        if sparse_comm is not None and sparse_comm != "auto":
            npcfg = dataclasses.replace(npcfg, sparse_comm=sparse_comm)
        npcfg = strategy.configure(npcfg)
        wl = resolve(self.workload.arch.name, device=self.device, mode="serve",
                     npcfg=npcfg, reduced=self.reduced, global_batch=max_batch)
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
