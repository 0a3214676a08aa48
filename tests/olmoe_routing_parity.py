"""How the full-width olmoe-1b-7b routes, in the port and in JAX, on the
same weights and the same micro-batch, on the CPU.

The first ``--layers`` layers of olmoe-1b-7b at its published widths
(d_model 2,048, 16 heads of 128, 64 experts top-8 with d_ff 1,024, bf16
params and compute) run in both packages: JAX's init from ``PRNGKey(0)``,
carried into the port by ``convert.lm_params_from_jax``; the embeddings of
the training stream's first micro-batch (``global_batch`` 8 x 4,096
tokens, data seed 0, key-centric clustering into 4 micro-batches; the
port's table init, normal(0, 0.01), seed 1), or, with ``--prefill``, the
serve cell's prompts (8 of 2,048 tokens, drawn uniformly from the
vocabulary as ``Session.serve`` draws them for seed 0).
Each layer is JAX's ``_apply_block`` and the port's ``_block``, fed the
same input (JAX's output of the layer before), so a gap does not carry
from layer to layer.

Per layer and package it prints one JSON line: the picks each expert was
given, the picks dropped over the capacity (``moe_capacity`` of the
micro-batch), the load-balance term, the share of picks the two packages
route alike, the MoE input's largest difference between the packages, and
how much of that input all tokens share (the norm of the mean row over the
mean row norm: 1 when every token sends the same vector).

Run (1.9 GB of bf16 weights per package; 15-25 s a layer on 8 cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/olmoe_routing_parity.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/olmoe_routing_parity.py --prefill

It is not collected by pytest: a full-width layer is too large for the
suite.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.configs.registry import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.embedding.table import init_table_state, make_mega_table_spec
from repro_torch.data.pipeline import make_cluster_transform
from repro_torch.data.synthetic import SyntheticLMStream
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT

ARCH = "olmoe-1b-7b"


def _tokens(cfg, prefill: bool) -> np.ndarray:
    """The scrambled table rows of the cell's first micro-batch, or of the
    serve cell's prompts: (B, T)."""
    spec = make_mega_table_spec(None, vocab_size=cfg.vocab_size, dim=cfg.d_model,
                                num_shards=1)
    if prefill:  # the serve cell's prompts: Session.serve's uniform draw, seed 0
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(8, 2048))
        return spec.scramble(torch.as_tensor(toks.astype(np.int32))).numpy(), spec
    batch = SyntheticLMStream(cfg.vocab_size, spec, 8, 4096, seed=0).make_batch(0)
    mb = make_cluster_transform(4, "keycentric")(
        {"keys": batch["keys"], "raw_keys": batch["raw_tokens"]})
    return mb["keys"][0], spec


def _capture(module, name, store):
    """Wrap ``module.name`` so each call records its input h and aux."""
    real = getattr(module, name)

    def spy(params, h, *a, **kw):
        out = real(params, h, *a, **kw)
        store.append((h, out[1]))
        return out

    setattr(module, name, spy)
    return real


def _stats(h: np.ndarray, ids: np.ndarray, aux: float, cfg) -> dict:
    n, k = ids.shape
    e = cfg.moe.num_experts
    cap = L.moe_capacity(n, cfg.moe)
    load = np.bincount(ids.reshape(-1), minlength=e)
    rows = h.reshape(n, -1).astype(np.float64)
    return {"tokens": n, "capacity": cap, "dropped": int(np.maximum(load - cap, 0).sum()),
            "dropped_share": float(np.maximum(load - cap, 0).sum() / (n * k)),
            "max_expert_picks": int(load.max()), "experts_over_capacity": int((load > cap).sum()),
            "aux": aux,
            "common_mode": float(np.linalg.norm(rows.mean(0))
                                 / np.linalg.norm(rows, axis=1).mean())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--prefill", action="store_true",
                    help="route the serve cell's prefill batch instead")
    args = ap.parse_args()
    jcfg = dataclasses.replace(jget_arch(ARCH).config, n_layers=args.layers)
    tcfg = dataclasses.replace(get_arch(ARCH).config, n_layers=args.layers)
    t0 = time.perf_counter()
    jp = jax.tree.map(np.asarray, JT.init_lm_params(jax.random.PRNGKey(0), jcfg))
    tp = lm_params_from_jax(jp)
    keys, spec = _tokens(tcfg, args.prefill)
    table = init_table_state(spec, device="cpu", generator=torch.Generator().manual_seed(1))
    emb = table.rows[torch.from_numpy(keys.astype(np.int64))]
    del table
    print(json.dumps({"arch": ARCH, "layers": args.layers, "batch": list(keys.shape),
                      "setup_s": time.perf_counter() - t0}), flush=True)

    cdt = jnp.bfloat16
    jparams = JT._cast_tree(jp, cdt)
    tparams = TT._cast_tree(tp, torch.bfloat16)
    tlayers = TT._layers(tparams, 0)
    b, t = keys.shape
    jpos = jnp.broadcast_to(jnp.arange(t), (b, t))
    tpos = torch.arange(t).expand(b, t)
    x = jnp.asarray(emb.numpy()).astype(cdt)
    jseen, tseen = [], []
    jreal = _capture(JL, "apply_moe", jseen)
    treal = _capture(L, "apply_moe", tseen)

    def jlayer(p, x_):
        """JAX's layer, and its MoE input (the spy's record of this trace)."""
        jseen.clear()
        out, aux = JT._apply_block(p, jcfg, "attn", "moe", x_, jpos, 1)
        return out, aux, jseen[0][0]

    jlayer = jax.jit(jlayer)
    try:
        for layer in range(args.layers):
            t1 = time.perf_counter()
            rep = jax.tree.map(lambda a: a[layer], jparams["blocks"])[0]
            jout, jaux, jh_b = jlayer(rep, x)
            jseen[:] = [(jh_b, jaux)]  # the trace's record held a tracer
            jh = np.asarray(jnp.asarray(jseen[0][0], jnp.float32))
            tseen.clear()
            with torch.no_grad():
                xt = torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(torch.bfloat16)
                TT._block(tlayers[layer], tcfg, "moe", xt, tpos)
            th = tseen[0][0].float().numpy()
            taux = float(tseen[0][1])
            lp = tlayers[layer]["moe"]
            tids = L._topk_routing(L._router_logits(lp, tseen[0][0].reshape(-1, tcfg.d_model)),
                                   tcfg.moe.top_k)[0].numpy()
            jlogits = jnp.asarray(jseen[0][0]).reshape(-1, jcfg.d_model).astype(jnp.float32) \
                @ rep["moe"]["router"]
            jids = np.asarray(JL._topk_routing(jlogits, jcfg.moe.top_k)[0])
            same = float(np.mean(np.sort(tids, 1) == np.sort(jids, 1)))
            scale = float(np.abs(jh).max())
            for pkg, h, ids, aux in (("jax", jh, jids, float(jaux)), ("port", th, tids, taux)):
                print(json.dumps({"layer": layer, "package": pkg,
                                  **_stats(h, ids, aux, tcfg)}), flush=True)
            print(json.dumps({"layer": layer, "picks_routed_alike": same,
                              "moe_input_max_abs_diff": float(np.abs(th - jh).max()),
                              "moe_input_max_abs": scale,
                              "seconds": time.perf_counter() - t1}), flush=True)
            x = jout
    finally:
        JL.apply_moe, L.apply_moe = jreal, treal
    return 0


if __name__ == "__main__":
    sys.exit(main())
