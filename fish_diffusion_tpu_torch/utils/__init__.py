"""Seeded random weights for modules that have no checkpoint yet, and the
device rule of the port's entry points."""

from __future__ import annotations

import torch
from torch import nn


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Entry points default to
    ``"cuda"``; without a card that default raises instead of falling back
    to the CPU, which a caller asks for with ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU"
        )
    return device


@torch.no_grad()
def init_random_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every parameter of ``module`` from a CPU ``torch.Generator``
    seeded with ``seed``, in ``named_parameters`` order: weights
    N(0, 1 / fan_in) with fan_in the product of all axes but the first,
    norm scales 1 + N(0, 0.02^2), biases N(0, 0.02^2). Zero-initialised
    layers (the WaveNet output projection) are drawn like any other, so
    that a random model's outputs are not trivially zero."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        draw = torch.randn(p.shape, generator=gen, dtype=torch.float32)
        if p.ndim >= 2:
            draw *= p[0].numel() ** -0.5
        elif name.endswith("norm.weight"):
            draw = 1.0 + 0.02 * draw
        else:
            draw *= 0.02
        p.copy_(draw)
    return module
