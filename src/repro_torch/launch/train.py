"""Training launcher: a thin CLI over ``Session.train``.

    python -m repro_torch.launch.train --arch dlrm-ctr --global-batch 8192 \\
        --steps 8 --bucket-slack 1.5
    python -m repro_torch.launch.train --arch hstu-industrial --reduced \\
        --device cpu --global-batch 16 --steps 4
    python -m repro_torch.launch.train --arch fuxi-kuairand --global-batch 256 \\
        --bucket-slack 1.5 --steps 6

runs on the GPU (``--device cpu`` for the plain PyTorch path, with
``--reduced`` for a CPU-sized model). ``--arch`` takes any ported registry
arch (``dlrm-*``, ``hstu-industrial``, ``fuxi-kuairand``, whose full
32.80 GB master fits one card, and the dense LMs and the encoder-decoder,
which train on ``--global-batch`` sequences of ``--seq-len`` tokens,
whisper-base's beside the stream's stub frames, pixtral-12b's first
n_positions of them the stream's stub patches):

    python -m repro_torch.launch.train --arch stablelm-3b --global-batch 8 \
        --seq-len 4096 --steps 4 --lr 3e-5
    python -m repro_torch.launch.train --arch whisper-base --global-batch 256 \
        --seq-len 448 --bucket-slack 1.5 --steps 4 --lr 3e-5
    python -m repro_torch.launch.train --arch stablelm-3b --reduced \
        --device cpu --global-batch 8 --seq-len 16 --steps 4
    python -m repro_torch.launch.train --arch pixtral-12b --reduced \
        --device cpu --global-batch 8 --seq-len 24 --steps 4

``--store`` picks the embedding
tier (``device``, ``host``: the master in host memory, ``cached``: a
device cache over it):

    REPRO_CACHE_POLICY=oracle python -m repro_torch.launch.train \
        --arch dlrm-drift --reduced --device cpu --store cached --steps 6

The full ``hstu-industrial`` master (309 GB) needs the host tier at a
size this launcher does not reach yet, so on one card it runs
``--reduced``.

``--ckpt-dir`` with ``--ckpt-every n`` saves every n steps, and a SIGTERM
(a preemption notice) saves at the next step boundary and ends the run;
``--resume``
restores the newest verifiable checkpoint there and trains the steps left
to ``--steps``, so a stopped run continues where it was saved:

    python -m repro_torch.launch.train --arch dlrm-ctr --reduced \
        --device cpu --global-batch 32 --steps 4 --ckpt-dir ck --ckpt-every 2
    python -m repro_torch.launch.train --arch dlrm-ctr --reduced \
        --device cpu --global-batch 32 --steps 6 --ckpt-dir ck --resume
"""
from __future__ import annotations

import argparse
import json
import signal

from ..api import Session, available_strategies
from ..core.store import STORES


def train(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--mode", default="nestpipe",
                   choices=[m for m in available_strategies() if m != "serve"])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--n-micro", type=int, default=4)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--global-batch", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=32,
                   help="tokens a sequence (dense LM archs; recsys archs "
                        "take their config's)")
    p.add_argument("--bucket-slack", type=float, default=4.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="restore the newest verifiable checkpoint in "
                        "--ckpt-dir and train the steps left to --steps")
    p.add_argument("--store", default="auto", choices=("auto", *STORES),
                   help="embedding storage tier (auto: $REPRO_STORE, then "
                        "device); the cached tier's policy is "
                        "$REPRO_CACHE_POLICY (default freq)")
    p.add_argument("--prefetch-ahead", type=int, default=1,
                   help="DBP retrieval lookahead depth k")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    args = p.parse_args(argv)

    sess = Session.from_arch(
        args.arch, mode=args.mode, reduced=args.reduced,
        global_batch=args.global_batch, seq_len=args.seq_len, n_micro=args.n_micro,
        bucket_slack=args.bucket_slack, lr=args.lr, seed=args.seed,
        store=args.store, prefetch_ahead=args.prefetch_ahead,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        preemption_signals=(signal.SIGTERM,), device=args.device)
    if args.resume and args.ckpt_dir:
        if sess.restore_if_available() is not None:
            print(f"[train] resumed from step {int(sess.state.step)}")
    report = sess.train(max(args.steps - int(sess.state.step), 0))
    print("[train] summary:", json.dumps(report.summary))
    return report.state, report.stats


if __name__ == "__main__":
    train()
