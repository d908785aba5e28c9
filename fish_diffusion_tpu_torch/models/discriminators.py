"""GAN discriminators and losses (``fish_diffusion_tpu/models/discriminators.py``):
the multi-period (MPD), multi-scale (MSD, flavor v1) and multi-resolution
(MRD, flavor v2) discriminators.

Parameters carry fish-diffusion's torch layout and names (reference
``nsf_hifigan/models.py:525-613``): weight-normed convs hold ``weight_g``
[C_out, 1, ...] and ``weight_v``, the spectral-normed ones (the first MSD
scale) ``weight_orig``. Weight norm follows flax ``nn.WeightNorm``
(``ops/blocked_conv.py:weight_norm_kernel``, 1e-12 inside the square
root). Spectral norm is explicit, not ``torch.nn.utils.spectral_norm``:
its power-iteration vectors ``weight_u``/``weight_v`` live in a dict that
the caller passes in and gets back, and they advance only when asked
(``update=True``), once per call, which the GAN step does in its
discriminator phase and not in its generator phase (the JAX step's
``spectral_d``).

The MSD runs channels-last ``[B, T, C]`` like the JAX package; its grouped
k = 41 layers 1, 2 and 5 are K6 (``ops/blocked_conv.py:grouped_conv1d``),
the other layers plain ``F.conv1d``, as they were plain XLA convs. The MPD's
2-D convs are plain ``F.conv2d`` (NCHW; its feature maps are the JAX ones
transposed). The MRD's resolution discriminators reflect-pad the waveform
by ``(n_fft - hop) // 2``, take K5's STFT magnitude without centring
(``sqrt(re^2 + im^2 + 1e-9)``: the eps keeps the gradient finite at silent
bins) and run their weight-normed 2-D convs channels-last ``[B, frames, F,
C]`` through K6 2-D (``ops/blocked_conv.py:conv2d_nhwc``); their feature
maps and scores have the JAX package's shapes. Discriminators compute in
float32; the STFTs here and in the losses run exact (K5 in float64,
``stft_magnitude(..., exact=True)``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import blocked_conv
from ..ops.blocked_conv import weight_norm_kernel
from ..ops.mel import LogMelSpectrogram, linear_spectrogram


def _l2normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize`` semantics: x / max(||x||, eps)."""
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


def spectral_norm_kernel(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         update: bool, eps: float = 1e-12):
    """Spectral normalisation with ``torch.nn.utils.spectral_norm``'s
    train-mode semantics: with ``update`` one power iteration on
    ``W = weight.reshape(C_out, -1)`` (u and v carry no gradient), then
    ``sigma = u . W v``, differentiated through W only. Returns
    ``(weight / sigma, u, v)``."""
    w = weight.reshape(weight.shape[0], -1)
    u, v = u.detach(), v.detach()
    if update:
        with torch.no_grad():
            v = _l2normalize(w.t() @ u, eps)
            u = _l2normalize(w @ v, eps)
    sigma = torch.dot(u, w @ v)
    return weight / sigma, u, v


class NormConv(nn.Module):
    """A conv's parameters under weight norm (``weight_g``, ``weight_v``) or
    spectral norm (``weight_orig``; u/v passed to ``weight``), torch layout
    [C_out, C_in / groups, *k]."""

    def __init__(self, c_in: int, c_out: int, kernel: Tuple[int, ...],
                 groups: int = 1, spectral: bool = False):
        super().__init__()
        shape = (c_out, c_in // groups) + tuple(kernel)
        self.spectral = spectral
        if spectral:
            self.weight_orig = nn.Parameter(torch.empty(shape))
        else:
            self.weight_g = nn.Parameter(torch.ones((c_out,) + (1,) * (len(shape) - 1)))
            self.weight_v = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def weight(self, uv=None, update: bool = False):
        """-> (normalised weight, new (u, v) or None)."""
        if self.spectral:
            w, u, v = spectral_norm_kernel(self.weight_orig, uv[0], uv[1], update)
            return w, (u, v)
        return weight_norm_kernel(self.weight_v, self.weight_g), None


class DiscriminatorP(nn.Module):
    """Period discriminator: fold the waveform into [T / p, p] and run
    strided 2-D convs. x [B, T] -> (score [B, N], fmap list)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels: Optional[Sequence[int]] = None,
                 leaky_relu_slope: float = 0.2):
        super().__init__()
        channels = list(channels or [1, 32, 128, 512, 1024, 1024])
        self.period, self.kernel_size, self.stride = period, kernel_size, stride
        self.slope = leaky_relu_slope
        self.convs = nn.ModuleList(
            NormConv(c_in, c_out, (kernel_size, 1))
            for c_in, c_out in zip(channels[:-1], channels[1:])
        )
        self.conv_post = NormConv(channels[-1], 1, (3, 1))

    def forward(self, x):
        b, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        h = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for i, conv in enumerate(self.convs):
            stride = (self.stride, 1) if i < len(self.convs) - 1 else (1, 1)
            h = F.conv2d(h, conv.weight()[0], conv.bias, stride,
                         (self.kernel_size // 2, 0))
            h = F.leaky_relu(h, self.slope)
            fmap.append(h)
        h = F.conv2d(h, self.conv_post.weight()[0], self.conv_post.bias, 1, (1, 0))
        fmap.append(h)
        return h.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 channels: Optional[Sequence[int]] = None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorP(p, channels=channels) for p in periods)

    def forward(self, x):
        scores, fmaps = [], []
        for d in self.discriminators:
            s, f = d(x)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped 1-D convs, channels-last. x [B, T] ->
    (score [B, N], fmap list of [B, T', C], new spectral u/v)."""

    # (ch, k, stride, groups, pad)
    SPECS = (
        (128, 15, 1, 1, 7),
        (128, 41, 2, 4, 20),
        (256, 41, 2, 16, 20),
        (512, 41, 4, 16, 20),
        (1024, 41, 4, 16, 20),
        (1024, 41, 1, 16, 20),
        (1024, 5, 1, 1, 2),
    )
    K6_LAYERS = (1, 2, 5)  # the JAX package's blocked_apply_grouped layers

    def __init__(self, use_spectral_norm: bool = False,
                 leaky_relu_slope: float = 0.1):
        super().__init__()
        self.slope = leaky_relu_slope
        self.use_spectral_norm = use_spectral_norm
        c_in, convs = 1, []
        for ch, k, _, g, _ in self.SPECS:
            convs.append(NormConv(c_in, ch, (k,), g, use_spectral_norm))
            c_in = ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = NormConv(c_in, 1, (3,), 1, use_spectral_norm)

    def spectral_names(self):
        """The u/v keys of this scale's spectral state, in call order."""
        names = [f"convs.{i}" for i in range(len(self.convs))] + ["conv_post"]
        return [(f"{n}.weight_u", f"{n}.weight_v") for n in names]

    def forward(self, x, spectral: Optional[dict] = None, update: bool = False):
        new = {}

        def weight(name, conv):
            if not self.use_spectral_norm:
                return conv.weight()[0]
            ku, kv = f"{name}.weight_u", f"{name}.weight_v"
            w, (u, v) = conv.weight((spectral[ku], spectral[kv]), update)
            new[ku], new[kv] = u, v
            return w

        h = x[:, :, None]
        fmap = []
        for i, ((_, k, s, g, p), conv) in enumerate(zip(self.SPECS, self.convs)):
            w = weight(f"convs.{i}", conv)
            if i in self.K6_LAYERS:
                h = blocked_conv.grouped_conv1d(h.contiguous(), w, conv.bias, s, g)
            else:
                h = F.conv1d(h.transpose(1, 2), w, conv.bias, s, p, 1, g).transpose(1, 2)
            h = F.leaky_relu(h, self.slope)
            fmap.append(h)
        w = weight("conv_post", self.conv_post)
        h = F.conv1d(h.transpose(1, 2), w, self.conv_post.bias, 1, 1).transpose(1, 2)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap, new


class DiscriminatorR(nn.Module):
    """Resolution discriminator over the STFT magnitude. x [B, T] ->
    (score [B, N], fmap list of [B, frames, F', C])."""

    # (ch, kernel, stride, padding)
    SPECS = (
        (32, (3, 9), (1, 1), (1, 4)),
        (32, (3, 9), (1, 2), (1, 4)),
        (32, (3, 9), (1, 2), (1, 4)),
        (32, (3, 9), (1, 2), (1, 4)),
        (32, (3, 3), (1, 1), (1, 1)),
    )

    def __init__(self, n_fft: int = 1024, hop_length: int = 120,
                 win_length: int = 600, leaky_relu_slope: float = 0.2):
        super().__init__()
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.slope = leaky_relu_slope
        c_in, convs = 1, []
        for ch, k, _, _ in self.SPECS:
            convs.append(NormConv(c_in, ch, k))
            c_in = ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = NormConv(c_in, 1, (3, 3))

    def forward(self, x):
        pad = (self.n_fft - self.hop_length) // 2
        y = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
        mag = linear_spectrogram(y, self.n_fft, self.hop_length, self.win_length,
                                 exact=True)
        h = mag.transpose(1, 2)[..., None].contiguous()  # [B, frames, F, 1]
        fmap = []
        for (_, _, s, p), conv in zip(self.SPECS, self.convs):
            h = blocked_conv.conv2d_nhwc(h, conv.weight()[0], conv.bias, s, p)
            h = F.leaky_relu(h, self.slope)
            fmap.append(h)
        h = blocked_conv.conv2d_nhwc(h, self.conv_post.weight()[0], self.conv_post.bias,
                                     (1, 1), (1, 1))
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, resolutions: Sequence[Tuple[int, int, int]] = (
            (1024, 120, 600), (2048, 240, 1200), (512, 50, 240))):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorR(*r) for r in resolutions)

    def forward(self, x):
        scores, fmaps = [], []
        for d in self.discriminators:
            s, f = d(x)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps


class MultiScaleDiscriminator(nn.Module):
    """Three scales with x2 average pooling between them; the first uses
    spectral norm, the others weight norm."""

    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=i == 0) for i in range(3))

    def forward(self, x, spectral: Optional[dict] = None, update: bool = False):
        scores, fmaps, new = [], [], {}
        h = x
        for i, d in enumerate(self.discriminators):
            if i:
                h = F.avg_pool1d(h[:, None], 4, 2, padding=2)[:, 0]
            prefix = f"discriminators.{i}."
            own = ({k[len(prefix):]: v for k, v in spectral.items() if k.startswith(prefix)}
                   if spectral else None)
            s, f, upd = d(h, own, update)
            new.update({prefix + k: v for k, v in upd.items()})
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps, new


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def discriminator_loss(real_scores, fake_scores, average: bool = False):
    """LSGAN D loss (summed over discriminators; averaged and halved with
    ``average``)."""
    losses = []
    for dr, dg in zip(real_scores, fake_scores):
        loss = torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
        losses.append(loss / 2 if average else loss)
    total = sum(losses)
    return total / len(losses) if average else total


def generator_adv_loss(fake_scores, average: bool = False):
    """LSGAN G loss."""
    total = sum(torch.mean((1.0 - dg) ** 2) for dg in fake_scores)
    return total / len(fake_scores) if average else total


def feature_loss(fmap_real, fmap_fake):
    """Feature matching: L1 over every map, times 2."""
    loss = 0.0
    for dr, dg in zip(fmap_real, fmap_fake):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def envelope_loss(y, y_hat, kernel: int = 100, stride: int = 50):
    """Max-pool envelope L1 of both polarities. y [B, T]."""

    def envelope(sig):
        return F.max_pool1d(sig[:, None], kernel, stride)[:, 0]

    return (torch.mean(torch.abs(envelope(y) - envelope(y_hat)))
            + torch.mean(torch.abs(envelope(-y) - envelope(-y_hat))))


def _smooth_l1(a, b):
    d = torch.abs(a - b)
    return torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))


@functools.lru_cache(maxsize=16)
def _mel_transform(sampling_rate, n_fft, win, hop, f_min, f_max, n_mels, device):
    return LogMelSpectrogram(sample_rate=sampling_rate, n_fft=n_fft,
                             win_length=win, hop_length=hop, f_min=f_min,
                             f_max=f_max, n_mels=n_mels, device=device, exact=True)


def multi_scale_mel_loss(y, y_hat, sampling_rate: int,
                         scales: Sequence[Tuple[int, int, int]],
                         loss: str = "smoothed-l1", f_min: float = 40.0,
                         f_max: float = 16000.0, n_mels: int = 128):
    """Multi-scale log-mel loss; scales [(n_fft, hop, win), ...]. y [B, T]."""
    losses = []
    for n_fft, hop, win in scales:
        mt = _mel_transform(sampling_rate, n_fft, win, hop, f_min, f_max, n_mels,
                            str(y.device))
        a, b = mt.log_mel(y), mt.log_mel(y_hat)
        losses.append(_smooth_l1(a, b) if loss == "smoothed-l1"
                      else torch.mean(torch.abs(a - b)))
    return sum(losses) / len(losses)


def multi_scale_stft_loss(y, y_hat, scales: Sequence[Tuple[int, int, int]] = (
        (512, 128, 512), (1024, 256, 1024), (2048, 512, 2048))):
    """Multi-scale linear-STFT magnitude L1 (centred frames). y [B, T]."""
    losses = []
    for n_fft, hop, win in scales:
        a = linear_spectrogram(y, n_fft, hop, win, center=True, exact=True)
        b = linear_spectrogram(y_hat, n_fft, hop, win, center=True, exact=True)
        losses.append(torch.mean(torch.abs(a - b)))
    return sum(losses) / len(losses)
