"""Small shared utilities: integer helpers, the scramble mixer, devices."""
from __future__ import annotations

import math
from typing import Optional

import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def coprime_mixer(modulus: int) -> int:
    """Pick a multiplier coprime with `modulus` for the bijective key
    scrambler (Knuth multiplicative constant, adjusted until coprime)."""
    p = 2654435761 % modulus
    if p in (0, 1):
        p = max(3, modulus // 2 + 1)
    while math.gcd(p, modulus) != 1:
        p += 1
        if p >= modulus:
            p = 3
    return p


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Without a GPU the default raises; it never drifts to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no GPU is visible; "
                "pass device='cpu' to run the plain PyTorch path")
        device = "cuda"
    return torch.device(device)
