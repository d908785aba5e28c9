"""WaveNet (DiffWave-style) denoiser (``fish_diffusion_tpu/models/wavenet.py``).

Layout ``[B, T, C]``. The residual stack runs K1, the hand-written CUDA
residual block (``csrc/wavenet_block.cu``), two kernels per block:
``residual_gate`` (the dilated k=3 product with bias, conditioner and gate)
and ``residual_out`` (the output product with the residual update and the
skip sum). ``residual_gate_reference`` and ``residual_out_reference`` are
their plain PyTorch versions, which the wrappers take for CPU tensors.

The per-block conditioner projections ``[L, B, T, 2R]`` are constant across
the reverse-diffusion steps, so ``prepare`` computes them once per sampling
call (the JAX ``project_conditioner`` hoist), together with the blocks'
weights packed in the layout the kernel reads.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from ..registry import DENOISERS
from .common import ConvNorm, LinearNorm, diffusion_embedding, mish, shift_time

_RSQRT2 = 1.0 / math.sqrt(2.0)


def residual_gate_reference(x, step, cond, w_conv, b_conv, dilation: int):
    """Plain version of K1's first kernel. x [B, T, R]; step [B, R]; cond
    [B, T, 2R]; w_conv [3R, 2R] (taps x[t-d], x[t], x[t+d] stacked on the
    input axis); b_conv [2R] -> g [B, T, R]."""
    R = x.shape[-1]
    y = x + step[:, None, :]
    z = (
        shift_time(y, dilation) @ w_conv[:R]
        + y @ w_conv[R : 2 * R]
        + shift_time(y, -dilation) @ w_conv[2 * R :]
    )
    z = z + b_conv
    z = z + cond
    gate, filt = z.chunk(2, dim=-1)
    return torch.sigmoid(gate) * torch.tanh(filt)


def residual_out_reference(g, x, skip, w_out, b_out):
    """Plain version of K1's second kernel. g, x, skip [B, T, R]; w_out
    [R, 2R]; b_out [2R] -> (x', skip')."""
    out = g @ w_out + b_out
    res, skip_add = out.chunk(2, dim=-1)
    return (x + res) * _RSQRT2, skip + skip_add


def residual_block_reference(x, skip, step, cond, w_conv, b_conv, w_out, b_out,
                             dilation: int):
    """Plain version of K1: one residual block -> (x', skip')."""
    g = residual_gate_reference(x, step, cond, w_conv, b_conv, dilation)
    return residual_out_reference(g, x, skip, w_out, b_out)


def _check_shapes(name, shapes: dict, R: int, *tensors):
    for arg, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} != {shape}")
    if R % 64:
        raise ValueError(f"{name}: channels {R} not a multiple of 64")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")


def residual_gate(x, step, cond, w_conv, b_conv, dilation: int):
    """K1, first kernel: the dilated k=3 product with bias, conditioner and
    gate. CPU tensors take ``residual_gate_reference``."""
    if not x.is_cuda:
        return residual_gate_reference(x, step, cond, w_conv, b_conv, dilation)
    kernels.require_cuda("residual_gate", x, step, cond, w_conv, b_conv)
    B, T, R = x.shape
    _check_shapes("residual_gate", {
        "step": (step, (B, R)), "cond": (cond, (B, T, 2 * R)),
        "w_conv": (w_conv, (3 * R, 2 * R)), "b_conv": (b_conv, (2 * R,)),
    }, R, x, step, cond, w_conv, b_conv)
    g = torch.empty_like(x)
    kernels.check(
        kernels.load_library("wavenet_block").wavenet_gate(
            kernels.dtype_code(x), x.data_ptr(), step.data_ptr(),
            w_conv.data_ptr(), b_conv.data_ptr(), cond.data_ptr(),
            g.data_ptr(), B, T, R, R, int(dilation), kernels.stream(),
        ),
        "wavenet_gate",
    )
    kernels.count_launch("wavenet_gate")
    return g


def residual_out(g, x, skip, w_out, b_out):
    """K1, second kernel: the output product with the residual update and
    the skip sum. CPU tensors take ``residual_out_reference``."""
    if not g.is_cuda:
        return residual_out_reference(g, x, skip, w_out, b_out)
    kernels.require_cuda("residual_out", g, x, skip, w_out, b_out)
    B, T, R = x.shape
    _check_shapes("residual_out", {
        "g": (g, (B, T, R)), "skip": (skip, (B, T, R)),
        "w_out": (w_out, (R, 2 * R)), "b_out": (b_out, (2 * R,)),
    }, R, g, x, skip, w_out, b_out)
    x_out, skip_out = torch.empty_like(x), torch.empty_like(skip)
    kernels.check(
        kernels.load_library("wavenet_block").wavenet_out(
            kernels.dtype_code(x), g.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr(), x.data_ptr(), skip.data_ptr(), x_out.data_ptr(),
            skip_out.data_ptr(), B, T, R, kernels.stream(),
        ),
        "wavenet_out",
    )
    kernels.count_launch("wavenet_out")
    return x_out, skip_out


def residual_block(x, skip, step, cond, w_conv, b_conv, w_out, b_out,
                   dilation: int):
    """K1: one residual block -> (x', skip')."""
    g = residual_gate(x, step, cond, w_conv, b_conv, dilation)
    return residual_out(g, x, skip, w_out, b_out)


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class DilatedConv(nn.Module):
    """Parameter holder of the k=3 dilated conv (key ``conv``,
    ``[2R, R, 3]``); tap 0 reads x[t-d]. The compute is K1."""

    def __init__(self, channels: int, out_channels: int, dilation: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, out_channels, 3, padding=dilation,
                              dilation=dilation)


class ResidualBlock(nn.Module):
    def __init__(self, d_encoder: int, residual_channels: int, dilation: int,
                 use_linear_bias: bool):
        super().__init__()
        r = residual_channels
        self.dilation = dilation
        self.diffusion_projection = LinearNorm(r, r, use_linear_bias)
        self.conv_layer = DilatedConv(r, 2 * r, dilation)
        self.conditioner_projection = ConvNorm(d_encoder, 2 * r)
        self.output_projection = ConvNorm(r, 2 * r)


@DENOISERS.register_module(name="WaveNetDenoiser")
class WaveNet(nn.Module):
    """x [B, T, mel_channels], diffusion_step [B], conditioner [B, T, d_encoder]
    -> noise estimate [B, T, mel_channels] (float32)."""

    def __init__(
        self,
        mel_channels: int = 128,
        d_encoder: int = 256,
        residual_channels: int = 512,
        residual_layers: int = 20,
        use_linear_bias: bool = False,
        dilation_cycle: Optional[int] = None,
    ):
        super().__init__()
        r = residual_channels
        self.residual_channels = r
        self.input_projection = ConvNorm(mel_channels, r)
        self.mlp = nn.Sequential(
            LinearNorm(r, 4 * r, use_linear_bias),
            Mish(),
            LinearNorm(4 * r, r, use_linear_bias),
        )
        self.residual_layers = nn.ModuleList(
            ResidualBlock(
                d_encoder,
                r,
                2 ** (i % dilation_cycle) if dilation_cycle else 1,
                use_linear_bias,
            )
            for i in range(residual_layers)
        )
        self.skip_projection = ConvNorm(r, r)
        self.output_projection = ConvNorm(r, mel_channels)

    def prepare(self, conditioner: torch.Tensor,
                cond_masks: Optional[torch.Tensor] = None) -> dict:
        """Per-sampling-call constants: the conditioner projections
        ``cond [L, B, T, 2R]`` and the blocks' packed weights."""
        c = conditioner.float()
        if cond_masks is not None:
            c = c.masked_fill(cond_masks[:, :, None], 0.0)
        r = self.residual_channels
        layers = self.residual_layers
        return {
            "cond": torch.stack([
                F.linear(c, l.conditioner_projection.conv.weight[:, :, 0],
                         l.conditioner_projection.conv.bias)
                for l in layers
            ]),
            "w_conv": torch.stack([
                l.conv_layer.conv.weight.permute(2, 1, 0).reshape(3 * r, 2 * r)
                for l in layers
            ]).contiguous(),
            "b_conv": torch.stack([l.conv_layer.conv.bias for l in layers]),
            "w_out": torch.stack([
                l.output_projection.conv.weight[:, :, 0].t() for l in layers
            ]).contiguous(),
            "b_out": torch.stack([l.output_projection.conv.bias for l in layers]),
        }

    def forward(
        self,
        x: torch.Tensor,
        diffusion_step: torch.Tensor,
        conditioner: Optional[torch.Tensor],
        x_masks: Optional[torch.Tensor] = None,
        cond_masks: Optional[torch.Tensor] = None,
        plan: Optional[dict] = None,
    ) -> torch.Tensor:
        if plan is None:
            plan = self.prepare(conditioner, cond_masks)
        x = F.relu(self.input_projection(x.float()))
        step = self.mlp(diffusion_embedding(diffusion_step, self.residual_channels))
        if x_masks is not None:
            x = x.masked_fill(x_masks[:, :, None], 0.0)

        skip = torch.zeros_like(x)
        for i, layer in enumerate(self.residual_layers):
            x, skip = residual_block(
                x, skip, layer.diffusion_projection(step), plan["cond"][i],
                plan["w_conv"][i], plan["b_conv"][i], plan["w_out"][i],
                plan["b_out"][i], layer.dilation,
            )

        x = skip * (1.0 / math.sqrt(len(self.residual_layers)))
        x = F.relu(self.skip_projection(x))
        x = self.output_projection(x)
        if x_masks is not None:
            x = x.masked_fill(x_masks[:, :, None], 0.0)
        return x.float()
