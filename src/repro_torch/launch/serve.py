"""Serving launcher: a thin CLI over the two ``Session`` serving paths.

Recsys archs serve embedding requests and check every served result
against a lookup straight from the master table:

    python -m repro_torch.launch.serve --arch dlrm-ctr --head dlrm \
        --requests 4096 --max-batch 512

LM and encoder-decoder archs run a batched prefill and greedy KV-cache
decode from a fresh seeded init (whisper-base on seeded stub frames,
pixtral-12b's prompts behind seeded stub patches):

    python -m repro_torch.launch.serve --arch stablelm-12b --batch 8 \
        --prompt-len 2048 --gen 32
    python -m repro_torch.launch.serve --arch whisper-base --batch 16 \
        --prompt-len 416 --gen 32
    python -m repro_torch.launch.serve --arch pixtral-12b --batch 8 \
        --prompt-len 2048 --gen 32

Both run on the GPU (``--device cpu`` for the plain PyTorch path).
"""
from __future__ import annotations

import argparse
import json

from ..api import Session
from ..configs.registry import get_arch


def serve(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    # LM decode path
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen", type=int, default=8)
    # recsys embedding-serving path
    p.add_argument("--store", default="auto",
                   help="embedding tier: device | host | cached | auto "
                        "(auto: $REPRO_STORE, then device)")
    p.add_argument("--requests", type=int, default=256)
    p.add_argument("--max-batch", type=int, default=32,
                   help="window size (requests coalesced per dispatch)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="latency bound: oldest queued request waits at most this")
    p.add_argument("--zipf-a", type=float, default=None,
                   help="request-key skew (default: the arch's training zipf_a)")
    p.add_argument("--qps", type=float, default=None,
                   help="open-loop arrival rate; omit for closed-loop throughput")
    p.add_argument("--head", default="embedding",
                   choices=("embedding", "dlrm"))
    args = p.parse_args(argv)

    if get_arch(args.arch).kind in ("lm", "encdec"):
        sess = Session.from_arch(args.arch, reduced=args.reduced, seed=args.seed,
                                 device=args.device)
        report = sess.serve(batch=args.batch, prompt_len=args.prompt_len,
                            gen=args.gen)
        print("[serve] summary:", json.dumps(report.summary))
        return report.tokens

    sess = Session.from_arch(args.arch, reduced=args.reduced, seed=args.seed,
                             store=args.store, device=args.device)
    report = sess.serve_embeddings(
        num_requests=args.requests, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, qps=args.qps, zipf_a=args.zipf_a,
        head=args.head, check_exact=True)
    print("[serve] summary:", json.dumps(report.summary))
    return report.results


if __name__ == "__main__":
    serve()
