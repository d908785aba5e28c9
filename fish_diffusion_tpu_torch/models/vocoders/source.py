"""NSF harmonic source from frame-rate f0 (``fish_diffusion_tpu/models/vocoders/source.py``).

The signal is that of the JAX package's ``BlockedSourceModule`` with
nearest f0 upsampling (the NSF-HiFiGAN case): per-sample f0 holds each
frame's value for ``hop`` samples; the phase is an exclusive sum of the
frames' phase advances, mod 1, plus the intra-frame advance
``(j + 1) * f0 / sr``; harmonic n has phase ``n * phase + rand_ini_n``
(rand_ini_0 = 0); the sines are gated by voicing, noise is added, and a
Dense(9 -> 1) with tanh merges them. The blocked ``[B, T, hop]`` layout was
a TPU device and is not carried over.

K3 computes it in two Triton kernels, replacing the JAX package's
``blocked_phase`` (``source.py:77``) and ``BlockedSineGen`` with the merge
(``source.py:92-169``):

- ``nsf_phase_base``: one program per batch row scans the T frame
  advances. Blocks run in no order on the card, so the scan across frames
  has to live inside one program (T <= 2600 frames fits one block). The sum
  runs in float64 and is reduced mod 1 at the end: exact for any order of
  summation, where the TPU's float32 mod-1 scan rounds at every step.
- ``nsf_merge``: one program per (batch row, tile of frames) builds the
  ``[frames, hop]`` phase, the 9 harmonics, the voicing gate, the noise and
  the merge, and writes only the merged ``[B, T * hop]`` signal; the 9
  harmonics never reach device memory.

On an H100 the pair is bound by memory: it reads the ``[B, T * hop, 9]``
noise (drawn outside, with a ``torch.Generator``; an in-kernel Philox draw
is later work) and writes ``[B, T * hop]``. ``nsf_phase_base_reference``
and ``nsf_merge_reference`` are the plain versions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ... import kernels

tl = None  # triton.language, bound at the first launch (no triton on import)
libdevice = None
_TRITON: dict = {}
_FRAMES_PER_PROGRAM = 4


def _phase_base_kernel(f0_ptr, base_ptr, T, sr, hop, BLOCK_T: tl.constexpr):
    b = tl.program_id(0)
    offs = tl.arange(0, BLOCK_T)
    mask = offs < T
    f0 = tl.load(f0_ptr + b * T + offs, mask=mask, other=0.0)
    advance = tl.math.div_rn(f0, sr) * hop
    advance = (advance - tl.floor(advance)).to(tl.float64)
    excl = tl.cumsum(advance, axis=0) - advance
    base = (excl - tl.floor(excl)).to(tl.float32)
    tl.store(base_ptr + b * T + offs, base, mask=mask)


def _source_kernel(f0_ptr, base_ptr, rand_ptr, noise_ptr, w_ptr, bias_ptr,
                   out_ptr, T, sr, sine_amp, noise_std,
                   HOP: tl.constexpr, FT: tl.constexpr, NH: tl.constexpr):
    b = tl.program_id(1)
    frames = tl.program_id(0) * FT + tl.arange(0, FT)
    fmask = frames < T
    f0 = tl.load(f0_ptr + b * T + frames, mask=fmask, other=0.0)
    base = tl.load(base_ptr + b * T + frames, mask=fmask, other=0.0)
    rad = tl.math.div_rn(f0, sr)
    j = tl.arange(0, HOP)
    phase = base[:, None] + rad[:, None] * (j + 1).to(tl.float32)[None, :]
    phase = phase - tl.floor(phase)
    uv = (f0 > 0.0).to(tl.float32)
    noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
    samples = (b * T + frames[:, None]) * HOP + j[None, :]
    smask = fmask[:, None] & (j[None, :] < HOP)
    acc = tl.zeros((FT, HOP), dtype=tl.float32)
    for n in tl.static_range(NH):
        ph = phase * (n + 1) + tl.load(rand_ptr + b * NH + n)
        ph = ph - tl.floor(ph)
        sine = libdevice.sin(6.283185307179586 * ph) * sine_amp
        nz = tl.load(noise_ptr + samples * NH + n, mask=smask, other=0.0)
        acc += (sine * uv[:, None] + noise_amp[:, None] * nz) * tl.load(w_ptr + n)
    out = libdevice.tanh(acc + tl.load(bias_ptr))
    tl.store(out_ptr + samples, out, mask=smask)


def _triton_kernels() -> dict:
    global tl, libdevice
    if not _TRITON:
        import triton
        import triton.language

        try:
            from triton.language.extra import libdevice as _libdevice
        except ImportError:
            from triton.language.extra.cuda import libdevice as _libdevice
        tl, libdevice = triton.language, _libdevice
        _TRITON["base"] = triton.jit(_phase_base_kernel)
        _TRITON["source"] = triton.jit(_source_kernel)
    return _TRITON


def _true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """IEEE division by a scalar (on CUDA, torch turns ``x / float`` into a
    multiplication by the reciprocal, which rounds differently)."""
    return x / torch.tensor(divisor, dtype=x.dtype, device=x.device)


def nsf_phase_base_reference(f0, sampling_rate: int, hop: int):
    """Plain version of K3's first kernel: f0 [B, T] -> the phase at the
    start of each frame, [B, T] in [0, 1)."""
    advance = torch.remainder(_true_div(f0, sampling_rate) * hop, 1.0).double()
    return torch.remainder(torch.cumsum(advance, dim=1) - advance, 1.0).float()


def nsf_merge_reference(f0, base, rand_ini, noise, weight, bias,
                        sampling_rate: int, hop: int, sine_amp: float = 0.1,
                        noise_std: float = 0.003):
    """Plain version of K3's second kernel. f0, base [B, T]; rand_ini [B, H]
    (column 0 is 0); noise [B, T * hop, H] standard normal; weight [H];
    bias [1] -> merged source [B, T * hop, 1]."""
    B, T = f0.shape
    H = rand_ini.shape[1]
    rad = _true_div(f0, sampling_rate)
    j = torch.arange(1, hop + 1, dtype=torch.float32, device=f0.device)
    phase = torch.remainder(base[..., None] + rad[..., None] * j, 1.0)

    harmonics = torch.arange(1, H + 1, dtype=torch.float32, device=f0.device)
    ph = phase[..., None] * harmonics + rand_ini[:, None, None, :]
    sines = torch.sin(2 * math.pi * torch.remainder(ph, 1.0)) * sine_amp

    uv = (f0 > 0).float()[:, :, None, None]
    noise_amp = uv * noise_std + (1 - uv) * sine_amp / 3
    sines = sines * uv + noise_amp * noise.view(B, T, hop, H)
    merged = sines @ weight + bias
    return torch.tanh(merged).reshape(B, T * hop, 1)


def nsf_source_reference(f0, rand_ini, noise, weight, bias, sampling_rate: int,
                         hop: int, sine_amp: float = 0.1,
                         noise_std: float = 0.003):
    """Plain version of K3: frame f0 [B, T] -> merged source [B, T * hop, 1]."""
    base = nsf_phase_base_reference(f0, sampling_rate, hop)
    return nsf_merge_reference(f0, base, rand_ini, noise, weight, bias,
                               sampling_rate, hop, sine_amp, noise_std)


def nsf_phase_base(f0, sampling_rate: int, hop: int):
    """K3, first kernel. CPU tensors take ``nsf_phase_base_reference``."""
    if not f0.is_cuda:
        return nsf_phase_base_reference(f0, sampling_rate, hop)
    kernels.require_cuda("nsf_phase_base", f0)
    if f0.dtype != torch.float32 or f0.ndim != 2:
        raise TypeError("nsf_phase_base: takes float32 f0 [B, T]")
    B, T = f0.shape
    base = torch.empty_like(f0)
    block_t = max(16, 1 << (T - 1).bit_length())
    _triton_kernels()["base"][(B,)](f0, base, T, float(sampling_rate), hop,
                                    BLOCK_T=block_t)
    kernels.count_launch("nsf_phase_base")
    return base


def nsf_merge(f0, base, rand_ini, noise, weight, bias, sampling_rate: int,
              hop: int, sine_amp: float = 0.1, noise_std: float = 0.003):
    """K3, second kernel. CPU tensors take ``nsf_merge_reference``."""
    if not f0.is_cuda:
        return nsf_merge_reference(f0, base, rand_ini, noise, weight, bias,
                                   sampling_rate, hop, sine_amp, noise_std)
    kernels.require_cuda("nsf_merge", f0, base, rand_ini, noise, weight, bias)
    if f0.dtype != torch.float32:
        raise TypeError(f"nsf_merge: takes float32, got {f0.dtype}")
    B, T = f0.shape
    H = rand_ini.shape[1]
    if (tuple(base.shape) != (B, T) or tuple(rand_ini.shape) != (B, H)
            or tuple(noise.shape) != (B, T * hop, H)
            or tuple(weight.shape) != (H,) or bias.numel() != 1):
        raise ValueError("nsf_merge: shapes do not match f0 [B, T]")
    if hop & (hop - 1):
        raise ValueError(f"nsf_merge: hop {hop} is not a power of two")
    out = torch.empty((B, T * hop, 1), dtype=f0.dtype, device=f0.device)
    grid = (-(-T // _FRAMES_PER_PROGRAM), B)
    _triton_kernels()["source"][grid](
        f0, base, rand_ini, noise, weight, bias, out, T, float(sampling_rate),
        float(sine_amp), float(noise_std), HOP=hop, FT=_FRAMES_PER_PROGRAM,
        NH=H, num_warps=8,
    )
    kernels.count_launch("nsf_merge")
    return out


def nsf_source(f0, rand_ini, noise, weight, bias, sampling_rate: int, hop: int,
               sine_amp: float = 0.1, noise_std: float = 0.003):
    """K3: frame f0 [B, T] -> merged source [B, T * hop, 1]."""
    base = nsf_phase_base(f0, sampling_rate, hop)
    return nsf_merge(f0, base, rand_ini, noise, weight, bias, sampling_rate,
                     hop, sine_amp, noise_std)


class SourceModule(nn.Module):
    """Harmonic source + Dense(H -> 1) merge (key ``l_linear``). The random
    initial phases and the noise come from ``generator`` unless given."""

    def __init__(self, sampling_rate: int, hop: int, harmonic_num: int = 8,
                 sine_amp: float = 0.1, noise_std: float = 0.003):
        super().__init__()
        self.sampling_rate = sampling_rate
        self.hop = hop
        self.dim = harmonic_num + 1
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.l_linear = nn.Linear(self.dim, 1)

    def forward(self, f0: torch.Tensor, rand_ini: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T = f0.shape
        if rand_ini is None:
            rand_ini = torch.rand((B, self.dim), generator=generator,
                                  device=f0.device)
            rand_ini[:, 0] = 0.0
        if noise is None:
            noise = torch.randn((B, T * self.hop, self.dim),
                                generator=generator, device=f0.device)
        return nsf_source(
            f0.float().contiguous(), rand_ini, noise,
            self.l_linear.weight[0].contiguous(), self.l_linear.bias,
            self.sampling_rate, self.hop, self.sine_amp, self.noise_std,
        )
