"""repro_torch — the PyTorch / CUDA port of the NestPipe reproduction.

A package beside the JAX reference (``repro``), with the same layout. It
imports torch and numpy, never jax and nothing of ``repro``. Its entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
CUDA tensor every ported kernel runs as a hand-written Hopper kernel
(``csrc/``), on a CPU tensor as its plain PyTorch version.

Ported: serving DLRM (``Session.from_arch("dlrm-ctr")
.serve_embeddings(head="dlrm")``) and training DLRM and HSTU under
NestPipe on the device tier (``Session.from_arch(...).train(steps)``, or
``Session.from_workload`` for a config outside the registry).
"""
