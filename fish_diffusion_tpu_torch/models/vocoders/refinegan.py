"""RefineGAN generator (``fish_diffusion_tpu/models/vocoders/refinegan.py``).

A UNet over the waveform: a template of the frame f0 (``source.py``: the
comb-tooth template, K9 comb, or with ``template_generator="sine"`` the
merged sine template, K9 sine), ``template_conv``, four levels of
(leaky-relu, skip, linear downsampling, channel-doubling ``ResBlock``),
the mel's ``mel_conv`` concatenated, then four levels of (leaky-relu,
linear upsampling, the template's strided ``source_conv`` added at the
first, the skip concatenated, ``ParallelResBlock``), ``output_conv`` and
tanh.

Layout ``[B, T, C]``. Every convolution is K4 (``nsf_hifigan.conv1d``,
``csrc/conv1d.cu``), with its leaky-relu input activation, residual add and
tanh fused where the JAX module applies them, and is differentiable
through K4's input gradient and ``conv1d_wgrad``. The weight-normed convs
use flax ``nn.WeightNorm``'s fold (``ops/blocked_conv.py:weight_norm_kernel``,
eps inside the square root). The JAX package's ``blocked_tail`` knob and
its space-to-depth layout were TPU devices and are not carried over; the
linear resampling is ``F.interpolate`` (``ops/tensor.py:repeat_expand``),
without antialiasing, as in the JAX module.

Random draws, in the JAX module's call order: the template's noise
(``[B, T * hop]``, or ``[B, T * hop, 1]`` for the sine template, whose one
harmonic has no random start phase) first, then one ``[B, T', C]`` draw
per ``AdaIN`` in module order (``up_res_0``'s ``adain1_k3``, ``adain2_k3``, ``adain1_k7``,
...). ``noise_shapes`` lists them; ``forward`` takes them as a list, or
draws them from a ``torch.Generator``. Parameters carry fish-diffusion's
torch names, which ``tools/refinegan/convert_checkpoint.py`` reads; the
sine template adds its merge, ``template_gen.merge``
(``convert.refinegan_from_jax`` carries it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.tensor import repeat_expand
from ...registry import VOCODERS
from ..discriminators import NormConv
from . import nsf_hifigan
from .source import CombToothSource, RefineSineSource


def linear_resize(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """[B, T, C] -> [B, new_len, C], torch linear, align_corners False."""
    return repeat_expand(x.transpose(1, 2), new_len).transpose(1, 2)


def _padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock(nn.Module):
    """(leaky, dilated weight-normed conv, leaky, conv) per dilation; the
    residual is kept where ``idx > 0`` or the block keeps its width."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 7,
                 dilation: Sequence[int] = (1, 3, 5), leaky_relu_slope: float = 0.2):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.dilation = kernel_size, tuple(dilation)
        self.slope = leaky_relu_slope
        self.convs1 = nn.ModuleList(
            NormConv(in_channels if i == 0 else out_channels, out_channels, (kernel_size,))
            for i in range(len(self.dilation)))
        self.convs2 = nn.ModuleList(
            NormConv(out_channels, out_channels, (kernel_size,)) for _ in self.dilation)

    def forward(self, x):
        k = self.kernel_size
        for idx, (d, c1, c2) in enumerate(zip(self.dilation, self.convs1, self.convs2)):
            xt = nsf_hifigan.conv1d(x, c1.weight()[0], c1.bias, dilation=d,
                                    padding=_padding(k, d), in_slope=self.slope)
            keep = idx != 0 or self.in_channels == self.out_channels
            x = nsf_hifigan.conv1d(xt, c2.weight()[0], c2.bias, dilation=d,
                                   padding=_padding(k, d), in_slope=self.slope,
                                   residual=x if keep else None)
        return x


class AdaIN(nn.Module):
    """``leaky_relu(x + noise * weight)``: learned-amplitude noise."""

    def __init__(self, channels: int, leaky_relu_slope: float = 0.2):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.slope = leaky_relu_slope

    def forward(self, x, noise):
        return F.leaky_relu(x + noise * self.weight, self.slope)


class ParallelResBlock(nn.Module):
    """A k = 7 ``input_conv``, then one (AdaIN, ResBlock, AdaIN) branch per
    kernel size (3, 7, 11), averaged. ``blocks.{m}`` holds branch m as
    (AdaIN, ResBlock, AdaIN), fish-diffusion's ``Sequential`` layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (3, 7, 11),
                 dilation: Sequence[int] = (1, 3, 5), leaky_relu_slope: float = 0.2):
        super().__init__()
        self.input_conv = nn.Conv1d(in_channels, out_channels, 7, padding=3)
        self.blocks = nn.ModuleList(
            nn.ModuleList([AdaIN(out_channels, leaky_relu_slope),
                           ResBlock(out_channels, out_channels, k, dilation,
                                    leaky_relu_slope),
                           AdaIN(out_channels, leaky_relu_slope)])
            for k in kernel_sizes)

    def forward(self, x, noise: List[torch.Tensor]):
        """``noise``: 2 draws [B, T, C] per branch, in branch order."""
        x = nsf_hifigan.conv1d(x, self.input_conv.weight, self.input_conv.bias,
                               padding=3)
        out = None
        for m, (ada1, res, ada2) in enumerate(self.blocks):
            y = ada2(res(ada1(x, noise[2 * m])), noise[2 * m + 1])
            out = y if out is None else out + y
        return out / len(self.blocks)


@VOCODERS.register_module(name="RefineGANGenerator")
class RefineGANGenerator(nn.Module):
    """mel [B, T, num_mels], f0 [B, T] -> audio [B, T * hop_length]."""

    def __init__(self, sampling_rate: int = 44100, hop_length: int = 256,
                 downsample_rates: Sequence[int] = (2, 2, 8, 8),
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 leaky_relu_slope: float = 0.2, num_mels: int = 128,
                 start_channels: int = 16, template_generator: str = "comb",
                 template_noise_std: float = 0.003):
        super().__init__()
        if template_generator not in ("comb", "sine"):
            raise ValueError(f"template_generator={template_generator!r}: "
                             "'comb' or 'sine'")
        if not int(np.prod(downsample_rates)) == int(np.prod(upsample_rates)) == hop_length:
            raise ValueError(f"rates {downsample_rates} and {upsample_rates} must "
                             f"multiply to hop_length {hop_length}")
        self.sampling_rate, self.hop_length = sampling_rate, hop_length
        self.downsample_rates = tuple(downsample_rates)
        self.upsample_rates = tuple(upsample_rates)
        self.slope = leaky_relu_slope
        self.num_mels = num_mels
        self.template_generator = template_generator
        source = CombToothSource if template_generator == "comb" else RefineSineSource
        self.template_gen = source(sampling_rate, hop_length, noise_std=template_noise_std)
        self.template_conv = NormConv(1, start_channels, (7,))
        channels = start_channels
        self.downsample_blocks = nn.ModuleList()
        for _ in self.downsample_rates:
            channels *= 2
            # fish-diffusion's Sequential(Upsample, ResBlock): the resample
            # has no parameters, the ResBlock is entry 1
            self.downsample_blocks.append(nn.Sequential(
                nn.Identity(), ResBlock(channels // 2, channels, 7, (1, 3, 5),
                                        leaky_relu_slope)))
        self.mel_conv = NormConv(num_mels, channels, (7,))
        channels *= 2
        stride_f0 = int(np.prod(self.upsample_rates[1:]))
        self.source_conv = nn.Conv1d(1, channels, stride_f0 * 2, stride=stride_f0,
                                     padding=stride_f0 // 2)
        self.upsample_conv_blocks = nn.ModuleList()
        self.up_channels = []
        for _ in self.upsample_rates:
            new = channels // 2
            self.upsample_conv_blocks.append(ParallelResBlock(
                channels + channels // 4, new, (3, 7, 11), (1, 3, 5), leaky_relu_slope))
            self.up_channels.append(new)
            channels = new
        self.output_conv = NormConv(channels, 1, (7,))

    def noise_shapes(self, batch: int, n_frames: int) -> List[tuple]:
        """The shapes of the random draws, in the JAX module's call order."""
        shapes = [(batch, n_frames * self.hop_length)
                  + ((1,) if self.template_generator == "sine" else ())]
        length = n_frames * self.hop_length
        for rate in self.downsample_rates:
            length //= rate
        for rate, ch in zip(self.upsample_rates, self.up_channels):
            length *= rate
            shapes += [(batch, length, ch)] * 6
        return shapes

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "RefineGANGenerator":
        """Draw the parameters from a CPU ``torch.Generator`` seeded with
        ``seed``: weight-normed kernels N(0, 0.01^2) (the JAX module's
        kernel init) with the scale g = ||v|| per output channel, so that
        the effective kernel is the one drawn (torch ``weight_norm``'s
        start; flax's scale of 1 gives every output channel a unit-norm
        kernel, and at full width the activations then grow until the
        output tanh saturates and every generator gradient is 0); plain
        convs and the sine template's merge N(0, 1 / fan_in) (flax's lecun
        normal, untruncated), biases 0, AdaIN weights 1."""
        gen = torch.Generator().manual_seed(seed)
        params = dict(self.named_parameters())
        for name, p in params.items():
            if name.endswith("weight_v"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
                g = params[name[: -len("weight_v")] + "weight_g"]
                g.copy_(torch.linalg.vector_norm(p, dim=tuple(range(1, p.ndim)),
                                                 keepdim=True))
            elif name.endswith("weight") and p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5)
            elif name.endswith("weight"):
                p.fill_(1.0)
            elif not name.endswith("weight_g"):
                p.zero_()
        return self

    def forward(self, mel: torch.Tensor, f0: torch.Tensor,
                noise: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if mel.shape[-1] != self.num_mels:
            raise ValueError(f"mel has {mel.shape[-1]} bins, expected {self.num_mels}")
        B, n_frames = mel.shape[0], mel.shape[1]
        shapes = self.noise_shapes(B, n_frames)
        if noise is None:
            noise = [torch.randn(s, generator=generator, device=mel.device) for s in shapes]
        if len(noise) != len(shapes):
            raise ValueError(f"{len(noise)} noise draws, expected {len(shapes)}")
        noise = [n.reshape(s) for n, s in zip(noise, shapes)]

        template = self.template_gen(f0, noise[0])  # [B, T * hop, 1]
        w, _ = self.template_conv.weight()
        x = nsf_hifigan.conv1d(template, w, self.template_conv.bias, padding=3)

        downs = []
        for rate, block in zip(self.downsample_rates, self.downsample_blocks):
            x = F.leaky_relu(x, self.slope)
            downs.append(x)
            x = block[1](linear_resize(x, x.shape[1] // rate).contiguous())

        w, _ = self.mel_conv.weight()
        mel_feat = nsf_hifigan.conv1d(mel.float().contiguous(), w, self.mel_conv.bias,
                                      padding=3)
        x = torch.cat([x, mel_feat], dim=-1)

        for idx, (rate, block) in enumerate(zip(self.upsample_rates,
                                                self.upsample_conv_blocks)):
            x = linear_resize(F.leaky_relu(x, self.slope), x.shape[1] * rate)
            if idx == 0:
                sc = self.source_conv
                x = nsf_hifigan.conv1d(template, sc.weight, sc.bias, stride=sc.stride[0],
                                       padding=sc.padding[0], residual=x.contiguous())
            down = downs[len(downs) - 1 - idx]
            x = torch.cat([x, down[:, : x.shape[1]]], dim=-1)
            x = block(x, noise[1 + 6 * idx : 7 + 6 * idx])

        w, _ = self.output_conv.weight()
        x = nsf_hifigan.conv1d(x, w, self.output_conv.bias, padding=3,
                               in_slope=self.slope, tanh=True)
        return x[:, :, 0]
