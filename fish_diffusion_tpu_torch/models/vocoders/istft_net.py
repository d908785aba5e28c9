"""iSTFTNet vocoder (``fish_diffusion_tpu/models/vocoders/istft_net.py``).

An NSF-HiFiGAN trunk with fewer upsampling levels that predicts, per
frame of a short STFT, a magnitude and a phase; the audio is their inverse
STFT. Layout ``[B, T, C]``.

``ISTFTNetGenerator`` follows the JAX module line by line:

- the harmonic source runs at the *trunk* rate, ``prod(upsample_rates)``
  samples a frame (64 at the defaults), with 9 harmonics and nearest f0
  upsampling (K3, ``source.SourceModule``);
- ``conv_pre``, then per level a leaky-relu (0.1) transposed conv, the
  source's noise conv added (kernel 2s, stride s = the product of the
  later rates, padding s / 2; 1 x 1 at the last level) and the mean of
  the ResBlock1 fans, every conv K4 (``nsf_hifigan.conv1d`` and
  ``conv_transpose1d``);
- a reflect pad of one frame on the left, leaky-relu 0.01 (fused into
  ``conv_post``'s load), ``conv_post`` to ``n_fft + 2`` channels;
- ``spec = exp(first n_fft / 2 + 1)``, ``phase = sin(the rest)``, float32,
  each ``[B, bins, frames]``.

``ISTFTNet`` is the registered vocoder wrapper (``VOCODERS``, as
``"ISTFTNet"``): ``spec2wav`` forms real = spec cos(phase), imag = spec
sin(phase) and inverts them with K5 istft (``ops/mel.py:istft``,
``csrc/istft.cu``); ``wav2spec`` is K5's log-mel. At the defaults (128
mels, hop 512 = 64 trunk samples x istft hop 8, n_fft 16) a segment of T
mel frames gives exactly T * 512 samples. Parameters carry fish-diffusion's
NSF-HiFiGAN names (the JAX tree has NSF-HiFiGAN's layout, so
``convert.istft_net_from_jax`` is ``nsf_hifigan_from_jax``).
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import mel as mel_ops
from ...ops.mel import LogMelSpectrogram
from ...registry import VOCODERS
from ...utils import resolve_device
from . import nsf_hifigan
from .nsf_hifigan import LRELU_SLOPE, ResBlock1
from .source import SourceModule


class ISTFTNetGenerator(nn.Module):
    """mel [B, T, num_mels], f0 [B, T] -> (spec, phase), each [B, n_fft // 2
    + 1, T * prod(upsample_rates) + 1]."""

    def __init__(
        self,
        num_mels: int = 128,
        sampling_rate: int = 44100,
        hop_size: int = 512,
        upsample_rates: Sequence[int] = (8, 8),
        upsample_kernel_sizes: Sequence[int] = (16, 16),
        upsample_initial_channel: int = 512,
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
        gen_istft_n_fft: int = 16,
        gen_istft_hop_size: int = 8,
    ):
        super().__init__()
        # hop_size and gen_istft_hop_size are the JAX module's fields; the
        # generator reads neither (``ISTFTNet`` checks and uses them)
        self.num_mels = num_mels
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.num_kernels = len(resblock_kernel_sizes)
        self.gen_istft_n_fft = gen_istft_n_fft

        self.m_source = SourceModule(sampling_rate, int(np.prod(self.upsample_rates)),
                                     harmonic_num=8)
        self.conv_pre = nn.Conv1d(num_mels, upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(self.upsample_rates, self.upsample_kernel_sizes)):
            ch_in, ch = ch, upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch_in, ch, k, u, padding=(k - u) // 2))
            if i + 1 < len(self.upsample_rates):
                stride_f0 = int(np.prod(self.upsample_rates[i + 1 :]))
                self.noise_convs.append(nn.Conv1d(1, ch, stride_f0 * 2, stride=stride_f0,
                                                  padding=stride_f0 // 2))
            else:
                self.noise_convs.append(nn.Conv1d(1, ch, 1))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, gen_istft_n_fft + 2, 7, padding=3)

    def forward(self, mel: torch.Tensor, f0: torch.Tensor,
                rand_ini: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if mel.shape[-1] != self.num_mels:
            raise ValueError(f"mel has {mel.shape[-1]} bins, expected {self.num_mels}")
        har_source = self.m_source(f0, rand_ini, noise, generator)

        x = nsf_hifigan.conv1d(mel.float().contiguous(), self.conv_pre.weight,
                               self.conv_pre.bias, padding=3)
        for i, (u, k) in enumerate(zip(self.upsample_rates, self.upsample_kernel_sizes)):
            up, nc = self.ups[i], self.noise_convs[i]
            x = nsf_hifigan.conv_transpose1d(x, up.weight, up.bias, u, (k - u) // 2,
                                             in_slope=LRELU_SLOPE)
            x = nsf_hifigan.conv1d(har_source, nc.weight, nc.bias, stride=nc.stride[0],
                                   padding=nc.padding[0], residual=x)
            xs = None
            for j in range(self.num_kernels):
                block = self.resblocks[i * self.num_kernels + j](x)
                xs = block if xs is None else xs + block
            x = xs / self.num_kernels

        x = F.pad(x.transpose(1, 2), (1, 0), mode="reflect").transpose(1, 2)
        x = nsf_hifigan.conv1d(x.contiguous(), self.conv_post.weight, self.conv_post.bias,
                               padding=3, in_slope=0.01)
        bins = self.gen_istft_n_fft // 2 + 1
        spec = torch.exp(x[:, :, :bins].float())
        phase = torch.sin(x[:, :, bins:].float())
        return spec.transpose(1, 2), phase.transpose(1, 2)


@VOCODERS.register_module(name="ISTFTNet")
class ISTFTNet:
    """Inference wrapper: ``spec2wav`` (the generator, then K5 istft) and
    ``wav2spec`` (the log-mel transform, K5). ``checkpoint_path`` names a
    pickle of the JAX package's generator params, carried across by
    ``convert.istft_net_from_jax``; without one, ``random_init`` draws every
    parameter from ``seed``. Other keyword arguments (the NSF-HiFiGAN keys
    a config may carry) are ignored, as the JAX wrapper ignores them. Runs
    on ``device``, the card unless the caller asks for the CPU."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        use_natural_log: bool = True,
        sampling_rate: int = 44100,
        mel_channels: int = 128,
        hop_length: int = 512,
        gen_istft_n_fft: int = 16,
        gen_istft_hop_size: int = 8,
        upsample_rates: Sequence[int] = (8, 8),
        upsample_kernel_sizes: Sequence[int] = (16, 16),
        random_init: bool = False,
        seed: int = 0,
        device="cuda",
        **kwargs,
    ):
        self.device = resolve_device(device)
        self.use_natural_log = use_natural_log
        self.sampling_rate = sampling_rate
        self.hop_length = hop_length
        self.gen_istft_n_fft = gen_istft_n_fft
        self.gen_istft_hop_size = gen_istft_hop_size
        self.generator = ISTFTNetGenerator(
            num_mels=mel_channels, sampling_rate=sampling_rate, hop_size=hop_length,
            upsample_rates=tuple(upsample_rates),
            upsample_kernel_sizes=tuple(upsample_kernel_sizes),
            gen_istft_n_fft=gen_istft_n_fft, gen_istft_hop_size=gen_istft_hop_size,
        )
        if int(np.prod(upsample_rates)) * gen_istft_hop_size != hop_length:
            raise ValueError(f"upsample_rates {tuple(upsample_rates)} x istft hop "
                             f"{gen_istft_hop_size} != hop_length {hop_length}")
        self.mel_transform = LogMelSpectrogram(
            sample_rate=sampling_rate, n_mels=mel_channels, hop_length=hop_length,
            use_natural_log=use_natural_log, device=self.device,
        )
        if checkpoint_path is not None:
            self.load_checkpoint(checkpoint_path)
        elif random_init:
            from ...utils import init_random_

            init_random_(self.generator, seed)
        self.generator.to(self.device).eval()

    def load_checkpoint(self, path: str):
        from ...convert import istft_net_from_jax

        with open(path, "rb") as f:
            params = pickle.load(f)
        self.generator.load_state_dict(istft_net_from_jax(params))

    @torch.inference_mode()
    def spec2wav(self, mel: torch.Tensor, f0: torch.Tensor,
                 rand_ini: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel [B, T, M] or [T, M] (log10 unless ``use_natural_log``), f0
        [B, T] or [T] -> audio [B, T * hop] or [T * hop]. The source's
        draws (rand_ini [B, 9], noise [B, T * prod(upsample_rates), 9]) come
        from ``generator`` unless given."""
        squeeze = mel.ndim == 2
        if squeeze:
            mel, f0 = mel[None], f0[None]
        if not self.use_natural_log:
            mel = 2.30259 * mel
        spec, phase = self.generator(mel, f0, rand_ini, noise, generator)
        wav = mel_ops.istft((spec * torch.cos(phase)).contiguous(),
                            (spec * torch.sin(phase)).contiguous(),
                            self.gen_istft_n_fft, self.gen_istft_hop_size)
        return wav[0] if squeeze else wav

    def wav2spec(self, audio, key_shift: float = 0.0, speed: float = 1.0):
        """audio [B, T] -> log-mel [B, T // hop, M] (channels-last), log10
        unless ``use_natural_log``."""
        mel = self.mel_transform.wav2spec(audio, key_shift=key_shift, speed=speed)
        return mel.transpose(1, 2)
