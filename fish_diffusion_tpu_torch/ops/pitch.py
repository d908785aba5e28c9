"""Pitch transforms (``fish_diffusion_tpu/ops/pitch.py``). Only the one the
SVC configs name is ported so far."""

from __future__ import annotations

import torch

_f0_max = 1100.0
_f0_min = 50.0


def pitch_to_scale(
    f0: torch.Tensor, f0_min: float = _f0_min, f0_max: float = _f0_max
) -> torch.Tensor:
    """Linear [0, 1] scaling with clipping; [B, T] gains a trailing axis."""
    f0_scale = ((f0 - f0_min) / (f0_max - f0_min)).clamp(0.0, 1.0)
    if f0.ndim == 2:
        f0_scale = f0_scale[..., None]
    return f0_scale
