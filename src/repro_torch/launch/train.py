"""Training launcher: a thin CLI over ``Session.train``.

    python -m repro_torch.launch.train --arch dlrm-ctr --global-batch 8192 \\
        --steps 8 --bucket-slack 1.5

runs on the GPU (``--device cpu`` for the plain PyTorch path, with
``--reduced`` for a CPU-sized model). No checkpoint flags: checkpoints are
not ported yet.
"""
from __future__ import annotations

import argparse
import json

from ..api import Session, available_strategies


def train(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--mode", default="nestpipe",
                   choices=[m for m in available_strategies() if m != "serve"])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--n-micro", type=int, default=4)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--global-batch", type=int, default=16)
    p.add_argument("--bucket-slack", type=float, default=4.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prefetch-ahead", type=int, default=1,
                   help="DBP retrieval lookahead depth k")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    args = p.parse_args(argv)

    sess = Session.from_arch(
        args.arch, mode=args.mode, reduced=args.reduced,
        global_batch=args.global_batch, n_micro=args.n_micro,
        bucket_slack=args.bucket_slack, lr=args.lr, seed=args.seed,
        prefetch_ahead=args.prefetch_ahead, device=args.device)
    report = sess.train(args.steps)
    print("[train] summary:", json.dumps(report.summary))
    return report.state, report.stats


if __name__ == "__main__":
    train()
