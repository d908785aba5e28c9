"""NSF-HiFiGAN vocoder (``fish_diffusion_tpu/models/vocoders/nsf_hifigan.py``).

Layout ``[B, T, C]``. Every convolution of the trunk is K4, the
hand-written CUDA convolution of ``csrc/conv1d.cu``: ``conv1d`` (stride,
dilation, symmetric padding, leaky-relu on the input as it is loaded, bias,
residual add and tanh in the epilogue) covers ``conv_pre``, both convs of
each ResBlock1 pair with ``x = xt + x``, the ``noise_convs`` with the
``x + x_source`` add, and ``conv_post``; ``conv_transpose1d`` covers the
upsampling layers with their leaky-relu. ``conv1d_reference`` and
``conv_transpose1d_reference`` are the plain versions, which the wrappers
take for CPU tensors. The harmonic source is K3 (``source.py``).

Training differentiates both wrappers (``_Conv1d``, ``_ConvTranspose1d``):
input gradients run through K4's own kernel with re-packed weights, weight
gradients through ``ops/blocked_conv.py:conv1d_wgrad``, and the derivatives
of the fused leaky-relu and tanh are elementwise PyTorch between them.

Parameters are stored in fish-diffusion's torch layout and names
(``conv_pre``, ``ups.{i}``, ``noise_convs.{i}``,
``resblocks.{r}.convs{1,2}.{j}``, ``conv_post``, ``m_source.l_linear``), so
that ``tools/nsf_hifigan/convert_checkpoint.py`` reads a port state dict.
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import kernels
from ...ops.blocked_conv import conv1d_wgrad
from ...ops.mel import LogMelSpectrogram
from ...registry import VOCODERS
from ...utils import resolve_device
from .source import SourceModule

LRELU_SLOPE = 0.1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def conv1d_reference(x, weight, bias, stride: int = 1, dilation: int = 1,
                     padding: int = 0, in_slope: Optional[float] = None,
                     residual=None, tanh: bool = False):
    """Plain version of K4's direct conv. x [B, T, C_in]; weight
    [C_out, C_in, K] (torch layout); residual [B, T_out, C_out]."""
    if in_slope is not None:
        x = F.leaky_relu(x, in_slope)
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride, padding,
                 dilation).transpose(1, 2)
    if residual is not None:
        y = y + residual
    return torch.tanh(y) if tanh else y


def conv_transpose1d_reference(x, weight, bias, stride: int, padding: int,
                               in_slope: Optional[float] = None,
                               output_padding: int = 0):
    """Plain version of K4's transposed conv. x [B, T, C_in]; weight
    [C_in, C_out, K] (torch layout)."""
    if in_slope is not None:
        x = F.leaky_relu(x, in_slope)
    return F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride,
                              padding, output_padding).transpose(1, 2)


def _launch_conv(name, transposed, x, w_packed, bias, residual, T_out, K,
                 stride, dilation, padding, in_slope, tanh):
    tensors = [x, w_packed, bias] + ([residual] if residual is not None else [])
    kernels.require_cuda(name, *tensors)
    B, T_in, C_in = x.shape
    C_out = w_packed.shape[2]
    if bias.shape != (C_out,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != ({C_out},)")
    if residual is not None and residual.shape != (B, T_out, C_out):
        raise ValueError(f"{name}: residual {tuple(residual.shape)} != "
                         f"{(B, T_out, C_out)}")
    if T_out <= 0:
        raise ValueError(f"{name}: empty output")
    lib = kernels.load_library("conv1d")
    out = torch.empty((B, T_out, C_out), dtype=x.dtype, device=x.device)
    kernels.check(
        lib.conv1d_forward(
            kernels.dtype_code(x), int(transposed), x.data_ptr(),
            w_packed.data_ptr(), bias.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), B, T_in, T_out, C_in, C_out, K, stride, dilation,
            padding, float(in_slope or 0.0), int(in_slope is not None),
            int(tanh), kernels.stream(),
        ),
        name,
    )
    kernels.count_launch(name)
    return out


def _conv1d_forward(x, weight, bias, stride: int = 1, dilation: int = 1,
                    padding: int = 0, in_slope: Optional[float] = None,
                    residual=None, tanh: bool = False):
    if not x.is_cuda:
        return conv1d_reference(x, weight, bias, stride, dilation, padding,
                                in_slope, residual, tanh)
    C_out, C_in, K = weight.shape
    if x.shape[-1] != C_in:
        raise ValueError(f"conv1d: input has {x.shape[-1]} channels, "
                         f"weight {C_in}")
    T_out = (x.shape[1] + 2 * padding - dilation * (K - 1) - 1) // stride + 1
    return _launch_conv("conv1d", False, x, weight.permute(2, 1, 0).contiguous(),
                        bias, residual, T_out, K, stride, dilation, padding,
                        in_slope, tanh)


def _conv_transpose1d_forward(x, weight, bias, stride: int, padding: int,
                              in_slope: Optional[float] = None,
                              T_out: Optional[int] = None):
    """``T_out`` (default the transposed conv's own length) cuts the output
    or pads it with zeros."""
    C_in, C_out, K = weight.shape
    natural = (x.shape[1] - 1) * stride - 2 * padding + K
    T_out = natural if T_out is None else T_out
    if not x.is_cuda:
        y = conv_transpose1d_reference(x, weight, bias, stride, padding, in_slope,
                                       max(0, min(stride - 1, T_out - natural)))
        return F.pad(y[:, :T_out], (0, 0, 0, max(0, T_out - y.shape[1])))
    if x.shape[-1] != C_in:
        raise ValueError(f"conv_transpose1d: input has {x.shape[-1]} "
                         f"channels, weight {C_in}")
    if K % stride:
        raise ValueError(f"conv_transpose1d: kernel {K} is not a multiple "
                         f"of stride {stride}")
    return _launch_conv("conv_transpose1d", True, x,
                        weight.permute(2, 0, 1).contiguous(), bias, None,
                        T_out, K, stride, 1, padding, in_slope, False)


def _leaky_grad(g, x, slope: Optional[float]):
    """g times the derivative of the input activation at x."""
    return g if slope is None else torch.where(x > 0, g, g * slope)


class _Conv1d(torch.autograd.Function):
    """K4's direct conv with its gradients: the input gradient through K4
    itself (a stride-1 conv's is a conv with flipped taps and swapped
    channels, padding (K - 1) * d - p; a strided conv's is a transposed
    conv), the weight gradient through ``conv1d_wgrad``, the derivatives of
    the input activation and the tanh as elementwise glue."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, stride, dilation, padding,
                in_slope, tanh):
        out = _conv1d_forward(x, weight, bias, stride, dilation, padding,
                              in_slope, residual, tanh)
        ctx.save_for_backward(x, weight, out if tanh else None)
        ctx.conf = (stride, dilation, padding, in_slope, tanh)
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, out = ctx.saved_tensors
        stride, dilation, padding, in_slope, tanh = ctx.conf
        if tanh:
            g = g * (1 - out * out)
        g = g.contiguous()
        C_out, C_in, K = weight.shape
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            zero = torch.zeros(C_in, dtype=g.dtype, device=g.device)
            if stride == 1:
                w = weight.flip(2).transpose(0, 1).contiguous()
                dx = _conv1d_forward(g, w, zero, 1, dilation,
                                     (K - 1) * dilation - padding)
            elif dilation == 1:
                dx = _conv_transpose1d_forward(g, weight, zero, stride, padding,
                                               T_out=x.shape[1])
            else:
                raise NotImplementedError("conv1d: input gradient of a "
                                          "strided, dilated conv")
            dx = _leaky_grad(dx, x, in_slope)
        if ctx.needs_input_grad[1]:
            dw = conv1d_wgrad(x, g, K, stride, dilation, padding,
                              slope_a=in_slope).permute(2, 1, 0)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1))
        dres = g if ctx.needs_input_grad[3] else None
        return dx, dw, db, dres, None, None, None, None, None


class _ConvTranspose1d(torch.autograd.Function):
    """K4's transposed conv with its gradients: the input gradient is a
    strided direct conv through K4 with the same weights, the weight
    gradient ``conv1d_wgrad`` with the output's gradient gathered."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, in_slope):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, in_slope)
        return _conv_transpose1d_forward(x, weight, bias, stride, padding,
                                         in_slope)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, in_slope = ctx.conf
        g = g.contiguous()
        C_in, C_out, K = weight.shape
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            zero = torch.zeros(C_in, dtype=g.dtype, device=g.device)
            dx = _leaky_grad(_conv1d_forward(g, weight, zero, stride, 1, padding),
                             x, in_slope)
        if ctx.needs_input_grad[1]:
            dw = conv1d_wgrad(g, x, K, stride, 1, padding,
                              slope_b=in_slope).permute(2, 1, 0)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1))
        return dx, dw, db, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def conv1d(x, weight, bias, stride: int = 1, dilation: int = 1,
           padding: int = 0, in_slope: Optional[float] = None, residual=None,
           tanh: bool = False):
    """K4 direct conv: ``act(x) * W + bias (+ residual)``, then tanh if
    asked; differentiable (``_Conv1d``). CPU tensors take
    ``conv1d_reference``."""
    if _needs_grad(x, weight, bias, residual):
        return _Conv1d.apply(x, weight, bias, residual, stride, dilation,
                             padding, in_slope, tanh)
    return _conv1d_forward(x, weight, bias, stride, dilation, padding,
                           in_slope, residual, tanh)


def conv_transpose1d(x, weight, bias, stride: int, padding: int,
                     in_slope: Optional[float] = None):
    """K4 transposed conv with torch ``ConvTranspose1d`` semantics, on
    ``act(x)``; differentiable (``_ConvTranspose1d``). CPU tensors take
    ``conv_transpose1d_reference``."""
    if _needs_grad(x, weight, bias):
        return _ConvTranspose1d.apply(x, weight, bias, stride, padding, in_slope)
    return _conv_transpose1d_forward(x, weight, bias, stride, padding, in_slope)


class ResBlock1(nn.Module):
    """HiFiGAN ResBlock1: 3 x (lrelu -> dilated conv -> lrelu -> conv, + x)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d))
            for d in dilation
        )
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size,
                      padding=get_padding(kernel_size, 1))
            for _ in dilation
        )

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = conv1d(x, c1.weight, c1.bias, dilation=c1.dilation[0],
                        padding=c1.padding[0], in_slope=LRELU_SLOPE)
            x = conv1d(xt, c2.weight, c2.bias, padding=c2.padding[0],
                       in_slope=LRELU_SLOPE, residual=x)
        return x


@VOCODERS.register_module(name="NsfHifiGANGenerator")
class NsfHifiGANGenerator(nn.Module):
    """mel [B, T, num_mels], f0 [B, T] -> audio [B, T * hop_size]."""

    def __init__(
        self,
        num_mels: int = 128,
        sampling_rate: int = 44100,
        hop_size: int = 512,
        upsample_rates: Sequence[int] = (8, 8, 2, 2, 2),
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4, 4),
        upsample_initial_channel: int = 512,
        resblock: str = "1",
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilation_sizes: Sequence[Sequence[int]] = (
            (1, 3, 5), (1, 3, 5), (1, 3, 5),
        ),
    ):
        super().__init__()
        if resblock != "1":
            raise NotImplementedError("only ResBlock1 is ported")
        self.num_mels = num_mels
        self.hop_size = hop_size
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.num_kernels = len(resblock_kernel_sizes)

        self.m_source = SourceModule(sampling_rate, hop_size, harmonic_num=8)
        self.conv_pre = nn.Conv1d(num_mels, upsample_initial_channel, 7,
                                  padding=3)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch_in, ch = ch, upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch_in, ch, k, u,
                                               padding=(k - u) // 2))
            if i + 1 < len(upsample_rates):
                stride_f0 = int(np.prod(upsample_rates[i + 1 :]))
                self.noise_convs.append(nn.Conv1d(
                    1, ch, stride_f0 * 2, stride=stride_f0,
                    padding=stride_f0 // 2,
                ))
            else:
                self.noise_convs.append(nn.Conv1d(1, ch, 1))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor, f0: torch.Tensor,
                rand_ini: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if mel.shape[-1] != self.num_mels:
            raise ValueError(f"mel has {mel.shape[-1]} bins, expected {self.num_mels}")
        har_source = self.m_source(f0, rand_ini, noise, generator)

        x = conv1d(mel.float().contiguous(), self.conv_pre.weight,
                   self.conv_pre.bias, padding=3)
        for i, (u, k) in enumerate(
            zip(self.upsample_rates, self.upsample_kernel_sizes)
        ):
            up, nc = self.ups[i], self.noise_convs[i]
            x = conv_transpose1d(x, up.weight, up.bias, u, (k - u) // 2,
                                 in_slope=LRELU_SLOPE)
            x = conv1d(har_source, nc.weight, nc.bias, stride=nc.stride[0],
                       padding=nc.padding[0], residual=x)
            xs = None
            for j in range(self.num_kernels):
                block = self.resblocks[i * self.num_kernels + j](x)
                xs = block if xs is None else xs + block
            x = xs / self.num_kernels

        x = conv1d(x, self.conv_post.weight, self.conv_post.bias, padding=3,
                   in_slope=0.01, tanh=True)
        return x[:, :, 0]


@VOCODERS.register_module(name="NsfHifiGAN")
class NsfHifiGAN:
    """Inference wrapper: ``spec2wav`` and ``wav2spec`` (the log-mel
    transform, K5). ``checkpoint_path`` names a pickle of the JAX package's
    generator params (the format ``tools/nsf_hifigan/convert_checkpoint.py``
    writes), carried across by ``convert.nsf_hifigan_from_jax``. Without
    one, ``random_init`` draws every parameter from ``seed``. Runs on
    ``device``, the card unless the caller asks for the CPU."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        sampling_rate: int = 44100,
        mel_channels: int = 128,
        n_fft: int = 2048,
        win_length: int = 2048,
        hop_length: int = 512,
        f_min: float = 40.0,
        f_max: float = 16000.0,
        use_natural_log: bool = True,
        generator_config: Optional[dict] = None,
        random_init: bool = False,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.use_natural_log = use_natural_log
        self.mel_transform = LogMelSpectrogram(
            sample_rate=sampling_rate, n_fft=n_fft, win_length=win_length,
            hop_length=hop_length, f_min=f_min, f_max=f_max,
            n_mels=mel_channels, use_natural_log=use_natural_log,
            device=self.device,
        )
        gen_cfg = dict(num_mels=mel_channels, sampling_rate=sampling_rate,
                       hop_size=hop_length)
        gen_cfg.update(generator_config or {})
        self.generator = NsfHifiGANGenerator(**gen_cfg)
        if int(np.prod(self.generator.upsample_rates)) != hop_length:
            raise ValueError(
                f"upsample_rates {self.generator.upsample_rates} do not multiply "
                f"to hop_length {hop_length}"
            )
        if checkpoint_path is not None:
            self.load_checkpoint(checkpoint_path)
        elif random_init:
            from ...utils import init_random_

            init_random_(self.generator, seed)
        self.generator.to(self.device).eval()

    def load_checkpoint(self, path: str):
        from ...convert import nsf_hifigan_from_jax

        with open(path, "rb") as f:
            params = pickle.load(f)
        self.generator.load_state_dict(nsf_hifigan_from_jax(params))

    @torch.inference_mode()
    def spec2wav(self, mel: torch.Tensor, f0: torch.Tensor,
                 rand_ini: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel [B, T, M] or [T, M] (log10 unless ``use_natural_log``),
        f0 [B, T] or [T] -> audio [B, T * hop] or [T * hop]."""
        squeeze = mel.ndim == 2
        if squeeze:
            mel, f0 = mel[None], f0[None]
        mel_in = mel if self.use_natural_log else 0.434294 * mel
        wav = self.generator(mel_in, f0, rand_ini, noise, generator)
        return wav[0] if squeeze else wav

    def wav2spec(self, audio, key_shift: float = 0.0, speed: float = 1.0):
        """audio [B, T] -> log-mel [B, T // hop, M] (channels-last), log10
        unless ``use_natural_log``."""
        mel = self.mel_transform.wav2spec(audio, key_shift=key_shift, speed=speed)
        return mel.transpose(1, 2)
