"""Mel spectrogram and STFT magnitude (``fish_diffusion_tpu/ops/mel.py``).

The windowed-DFT basis and the mel filter bank are built on the host in
float64 and cast to float32, as in the JAX package. The STFT magnitude is
K5, the hand-written CUDA product of ``csrc/stft.cu``: ``stft_magnitude``
launches it for a CUDA tensor and takes ``stft_magnitude_reference`` (frames
by ``unfold``, one float32 ``matmul``) for a CPU tensor. The mel projection
``[n_mels, bins] @ spec`` stays ``torch.matmul`` in float32, as it stood
outside the TPU kernel.

Conventions kept from the JAX package:
- reflect padding of ``(win - hop) / 2`` samples each side, ``center=False``;
- magnitude ``sqrt(re^2 + im^2 + 1e-9)``;
- key shift: n_fft and the window scaled by ``2 ** (key_shift / 12)`` and
  rounded (2299 at +2, not a power of two), the spectrum cropped or padded
  back to ``n_fft // 2 + 1`` bins and rescaled by ``win / win_new``;
- librosa's slaney-scale, slaney-norm filter bank;
- log compression: natural log of ``clamp(x, 1e-5)``, times 0.434294 for
  log10 mels.

The backward of the STFT (the JAX package's hand VJP) and ``istft`` are not
ported yet (ROADMAP Queue 2, K5).
"""

from __future__ import annotations

import functools
import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..utils import resolve_device

# ---------------------------------------------------------------------------
# Filter bank and window (host, cached)
# ---------------------------------------------------------------------------


def _hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa ``htk=False``)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp

    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0

    log_t = frequencies >= min_log_hz
    return np.where(
        log_t,
        min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels

    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0

    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filter_bank(
    sample_rate: int = 44100,
    n_fft: int = 2048,
    n_mels: int = 128,
    f_min: float = 40.0,
    f_max: float = 16000.0,
) -> np.ndarray:
    """librosa-compatible slaney/slaney mel filter bank [n_mels, n_fft//2+1]."""
    fftfreqs = np.linspace(0, sample_rate / 2, 1 + n_fft // 2)

    mel_min, mel_max = _hz_to_mel(np.array(f_min)), _hz_to_mel(np.array(f_max))
    mel_f = _mel_to_hz(np.linspace(mel_min, mel_max, n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])  # slaney norm
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window``'s default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_kernel(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed DFT basis [2 * bins, 1, n_fft] (the JAX package's layout):
    row k < bins is the cos part of bin k, row bins + k its -sin part, each
    times the centred, zero-padded Hann window."""
    bins = n_fft // 2 + 1
    window = np.zeros(n_fft, dtype=np.float64)
    pad = (n_fft - win_length) // 2
    window[pad : pad + win_length] = _hann_window(win_length).astype(np.float64)

    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(bins, dtype=np.float64)
    angle = 2 * np.pi * k[:, None] * n[None, :] / n_fft
    real = np.cos(angle) * window[None, :]
    imag = -np.sin(angle) * window[None, :]
    return np.concatenate([real, imag], axis=0)[:, None, :].astype(np.float32)


@functools.lru_cache(maxsize=16)
def _dft_basis(n_fft: int, win_length: int, device: str) -> torch.Tensor:
    """K5's operand: ``_dft_kernel`` as a contiguous [n_fft, 2 * bins]
    float32 tensor on ``device``."""
    k = _dft_kernel(n_fft, win_length)[:, 0, :]
    return torch.from_numpy(np.ascontiguousarray(k.T)).to(device)


# ---------------------------------------------------------------------------
# K5: the STFT magnitude
# ---------------------------------------------------------------------------


def stft_magnitude_reference(y: torch.Tensor, basis: torch.Tensor,
                             hop: int) -> torch.Tensor:
    """Plain version of K5. y [B, T_pad], basis [n_fft, 2 * bins] ->
    [B, bins, F] with F = (T_pad - n_fft) // hop + 1."""
    n_fft, two_bins = basis.shape
    bins = two_bins // 2
    spec = y.unfold(-1, n_fft, hop) @ basis  # [B, F, 2 * bins]
    re, im = spec[..., :bins], spec[..., bins:]
    return torch.sqrt(re * re + im * im + 1e-9).transpose(1, 2)


def stft_magnitude(y: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    """K5: the STFT magnitude without centring, ``sqrt(re^2 + im^2 + 1e-9)``
    of the windowed DFT (``basis`` from ``_dft_basis``) of every frame of
    ``y`` [B, T_pad] -> [B, bins, F]. CPU tensors take
    ``stft_magnitude_reference``."""
    if not y.is_cuda:
        return stft_magnitude_reference(y, basis, hop)
    kernels.require_cuda("stft_magnitude", y, basis)
    if y.dtype != torch.float32:
        raise TypeError(f"stft_magnitude: takes float32, got {y.dtype}")
    if y.ndim != 2 or basis.ndim != 2 or basis.shape[1] % 2:
        raise ValueError(f"stft_magnitude: y {tuple(y.shape)}, basis "
                         f"{tuple(basis.shape)}: expected [B, T] and [n_fft, 2 * bins]")
    B, T_pad = y.shape
    n_fft, bins = basis.shape[0], basis.shape[1] // 2
    if T_pad < n_fft or hop < 1:
        raise ValueError(f"stft_magnitude: {T_pad} samples, n_fft {n_fft}, hop {hop}")
    n_frames = (T_pad - n_fft) // hop + 1
    out = torch.empty((B, bins, n_frames), dtype=torch.float32, device=y.device)
    lib = kernels.load_library("stft")
    kernels.check(
        lib.stft_magnitude(y.data_ptr(), basis.data_ptr(), out.data_ptr(), B,
                           T_pad, n_fft, hop, bins, n_frames, kernels.stream()),
        "stft_magnitude",
    )
    kernels.count_launch("stft_magnitude")
    return out


# ---------------------------------------------------------------------------
# Dynamic-range compression
# ---------------------------------------------------------------------------


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0,
                              clip_val: float = 1e-5) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor, C: float = 1.0) -> torch.Tensor:
    return torch.exp(x) / C


# ---------------------------------------------------------------------------
# LogMelSpectrogram
# ---------------------------------------------------------------------------


class LogMelSpectrogram:
    """Pitch-adjustable log-mel transform: the STFT magnitude (K5), the mel
    projection and the log compression that NSF-HiFiGAN's ``wav2spec``
    applies. Runs on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(
        self,
        sample_rate: int = 44100,
        n_fft: int = 2048,
        win_length: int = 2048,
        hop_length: int = 512,
        f_min: float = 40.0,
        f_max: float = 16000.0,
        n_mels: int = 128,
        use_natural_log: bool = True,
        device="cuda",
    ):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.f_min = f_min
        self.f_max = f_max
        self.n_mels = n_mels
        self.use_natural_log = use_natural_log
        self.device = resolve_device(device)
        self.mel_basis = torch.from_numpy(
            mel_filter_bank(sample_rate, n_fft, n_mels, f_min, f_max)
        ).to(self.device)

    def _input(self, y) -> torch.Tensor:
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        return y[None] if y.ndim == 1 else y

    def spectrogram(self, y, key_shift: float = 0.0, speed: float = 1.0):
        """Linear magnitude spectrogram, [B, n_fft // 2 + 1, frames]."""
        factor = 2 ** (key_shift / 12)
        n_fft_new = int(np.round(self.n_fft * factor))
        win_new = int(np.round(self.win_length * factor))
        hop = int(np.round(self.hop_length * speed))

        y = self._input(y)
        pad = int((win_new - hop) / 2)
        y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0].contiguous()
        spec = stft_magnitude(y, _dft_basis(n_fft_new, win_new, str(y.device)), hop)

        if key_shift != 0:
            size = self.n_fft // 2 + 1
            if spec.shape[1] < size:
                spec = F.pad(spec, (0, 0, 0, size - spec.shape[1]))
            spec = spec[:, :size, :] * (self.win_length / win_new)
        return spec

    def __call__(self, y, key_shift: float = 0.0, speed: float = 1.0):
        """Raw (uncompressed) mel spectrogram, [B, n_mels, frames]."""
        spec = self.spectrogram(y, key_shift=key_shift, speed=speed)
        return torch.matmul(self.mel_basis, spec)

    def compress(self, mel: torch.Tensor) -> torch.Tensor:
        mel = dynamic_range_compression(mel)
        if not self.use_natural_log:
            mel = mel * 0.434294  # ln -> log10
        return mel

    @torch.inference_mode()
    def wav2spec(self, y, key_shift: float = 0.0, speed: float = 1.0):
        """Audio [B, T] or [T] -> log-mel [B, n_mels, frames]."""
        return self.compress(self(y, key_shift=key_shift, speed=speed))
