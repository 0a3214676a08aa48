"""Inputs captured from the port's ``fuxi-reduced`` model on the CPU, for
the tests of the tf32x3 flash kernels' CPU models."""
import functools

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels import dispatch
from repro_torch.models import FuXi


@functools.lru_cache(maxsize=None)
def fuxi_layer0_qkv():
    """q, k, v as the port's ``fuxi-reduced`` layer 0 hands them to
    ``dispatch.flash_attention`` on the CPU (seeded weights and lookups;
    (2, 32, 4, 16), causal)."""
    cfg = get_arch("fuxi-kuairand").reduced
    model = FuXi(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    emb = np.random.default_rng(4).normal(size=(2, cfg.seq_len, cfg.max_table_dim)) * 0.1
    kept, real = [], dispatch.flash_attention

    def spy(q, k, v, causal=True):
        kept.append((q.clone(), k.clone(), v.clone()))
        return real(q, k, v, causal)

    dispatch.flash_attention = spy
    try:
        with torch.no_grad():
            model(torch.from_numpy(emb.astype(np.float32)))
    finally:
        dispatch.flash_attention = real
    return kept[0]
