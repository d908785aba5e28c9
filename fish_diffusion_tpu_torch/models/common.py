"""Shared building blocks (``fish_diffusion_tpu/models/common.py``).

Sequence tensors are channels-last ``[B, T, C]`` at every public function,
as in the JAX package. Parameters follow fish-diffusion's torch key layout
(``LinearNorm.linear``, ``ConvNorm.conv``), so that
``tools/diffusion/convert_torch_checkpoint.py`` reads a port state dict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def diffusion_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal diffusion-step embedding: t [B] -> [B, dim]."""
    half_dim = dim // 2
    emb_scale = math.log(10000) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb_scale
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def shift_time(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Zero-filled shift along axis 1: out[:, t] = x[:, t - shift]."""
    if shift == 0:
        return x
    T = x.shape[1]
    out = torch.zeros_like(x)
    if abs(shift) >= T:
        return out
    if shift > 0:
        out[:, shift:] = x[:, : T - shift]
    else:
        out[:, : T + shift] = x[:, -shift:]
    return out


class LinearNorm(nn.Module):
    """Linear layer; the JAX ``LinearNorm`` (keys ``linear.weight/bias``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False):
        super().__init__()
        self.linear = nn.Linear(in_features, out_features, bias=bias)

    def forward(self, x):
        return self.linear(x)


class ConvNorm(nn.Module):
    """Pointwise conv over channels-last input; the JAX ``Conv1x1``. Stored
    as a torch ``Conv1d(k=1)`` (keys ``conv.weight [out, in, 1]``)."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, 1, bias=bias)

    def forward(self, x):
        return F.linear(x, self.conv.weight[:, :, 0], self.conv.bias)
