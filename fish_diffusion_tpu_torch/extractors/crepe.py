"""CREPE pitch (``fish_diffusion_tpu/extractors/crepe.py``).

The network of Kim et al. 2018 in torchcrepe's state-dict layout
(``conv{i}``, ``conv{i}_BN``, ``classifier``; the keys
``tools/preprocessing/convert_crepe_checkpoint.py:TORCHCREPE_KEYS`` names):
six layers over 1024-sample frames at 16 kHz, each pad -> conv -> ReLU ->
BatchNorm (eps 1e-3, running statistics) -> max-pool 2 (kernel 512 stride
4 with pads (254, 254) first, kernel 64 with pads (31, 32) after), a
position-major flatten and a sigmoid classifier over 360 pitch bins of 20
cents. Its convs and classifier are plain ``F.conv2d`` / ``F.linear``.

``CrepePitchExtractor`` frames the audio resampled to 16 kHz every 80
samples (5 ms), runs the network over a frame bucket (a multiple of 256),
masks the bins outside [f0_min, f0_max] to -inf, decodes the bins with K8
CREPE (``pitch.crepe_viterbi``, the hand-written CUDA kernel of
``csrc/viterbi_dense.cu``: the softmax of the activations as observations,
a 12-bin triangular transition prior, a uniform start; the bucket's pad
frames take uniform observations), reads f0 as the salience-weighted
cents within +-4 bins, and post-processes as torchcrepe's README chain
does: periodicity median-3, -60 dB A-weighted silence gate, periodicity
threshold, f0 mean-3 (NaN-aware), NaN -> 0. The loudness is host numpy,
as in the JAX package.

Without a checkpoint, ``random_init`` draws the weights from ``seed``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..registry import PITCH_EXTRACTORS
from ..utils import resolve_device
from .pitch import BasePitchExtractor, crepe_viterbi

PITCH_BINS = 360
WINDOW_SIZE = 1024
CREPE_SAMPLE_RATE = 16000
CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1997.3794084376191

_CAPACITY_CHANNELS = {
    "full": (1024, 128, 128, 128, 256, 512),
    "tiny": (128, 16, 16, 16, 32, 64),
}
_KERNELS = (512, 64, 64, 64, 64, 64)
_STRIDES = (4, 1, 1, 1, 1, 1)
_PADS = ((254, 254), (31, 32), (31, 32), (31, 32), (31, 32), (31, 32))


class Crepe(nn.Module):
    """CREPE salience network: frames [B, 1024] -> sigmoid activations
    [B, 360]."""

    def __init__(self, capacity: str = "full"):
        super().__init__()
        channels = _CAPACITY_CHANNELS[capacity]
        c_in = (1,) + channels[:-1]
        for i in range(6):
            setattr(self, f"conv{i + 1}", nn.Conv2d(c_in[i], channels[i], (_KERNELS[i], 1),
                                                    (_STRIDES[i], 1)))
            setattr(self, f"conv{i + 1}_BN", nn.BatchNorm2d(channels[i], eps=1e-3))
        self.classifier = nn.Linear(4 * channels[-1], PITCH_BINS)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames[:, None, :, None]
        for i in range(6):
            x = F.pad(x, (0, 0) + _PADS[i])
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
            x = getattr(self, f"conv{i + 1}_BN")(x)
            x = F.max_pool2d(x, (2, 1), (2, 1))
        # [B, C, 4, 1] -> [B, 4 * C], position-major (torchcrepe's order)
        x = x.permute(0, 2, 1, 3).reshape(x.shape[0], -1)
        return torch.sigmoid(self.classifier(x))


def init_crepe_(model: Crepe, seed: int = 0) -> Crepe:
    """Seeded random weights: conv and classifier weights N(0, 1 / fan_in)
    from a CPU ``torch.Generator``, biases 0, BatchNorm at its identity
    (scale 1, shift 0, running mean 0, variance 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5)
            elif "_BN" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.zero_()
            elif name.endswith("running_var"):
                b.fill_(1.0)
    return model


# -- framing / decoding ------------------------------------------------------


def frame_audio_16k(audio: torch.Tensor, hop_length: int) -> torch.Tensor:
    """torchcrepe's preprocessing: zero-pad WINDOW_SIZE // 2 each side,
    ``1 + T // hop`` frames of 1024 samples, each standardised (mean 0,
    standard deviation with the N - 1 divisor, floored at 1e-10)."""
    n_frames = 1 + audio.shape[0] // hop_length
    padded = F.pad(audio, (WINDOW_SIZE // 2, WINDOW_SIZE // 2))
    idx = (torch.arange(n_frames, device=audio.device)[:, None] * hop_length
           + torch.arange(WINDOW_SIZE, device=audio.device)[None, :])
    frames = padded[torch.clamp(idx, max=padded.shape[0] - 1)]
    frames = frames - frames.mean(dim=1, keepdim=True)
    return frames / torch.clamp(frames.std(dim=1, correction=1, keepdim=True), min=1e-10)


def frequency_to_bin(freq: float, quantize=np.floor) -> int:
    cents = 1200.0 * np.log2(freq / 10.0)
    return int(quantize((cents - CENTS_OFFSET) / CENTS_PER_BIN))


def _transition_matrix() -> np.ndarray:
    """torchcrepe's transition prior: max(12 - |i - j|, 0), row-normalised
    (host float64, returned float32)."""
    xx, yy = np.meshgrid(np.arange(PITCH_BINS), np.arange(PITCH_BINS))
    t = np.maximum(12 - np.abs(xx - yy), 0).astype(np.float64)
    return (t / t.sum(axis=1, keepdims=True)).astype(np.float32)


def _nan_windows(x: torch.Tensor, win: int) -> torch.Tensor:
    """[T] -> [T, win] reflect-padded sliding windows."""
    pad = win // 2
    return F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0].unfold(0, win, 1)


def median_filter(x: torch.Tensor, win: int = 3) -> torch.Tensor:
    """NaN-aware sliding median (torchcrepe.filter.median)."""
    w = _nan_windows(x, win)
    valid = ~torch.isnan(w)
    n_valid = valid.sum(dim=1)
    sorted_w = torch.sort(torch.where(valid, w, math.inf), dim=1).values
    last = torch.clamp(n_valid - 1, min=0)
    mid = last // 2
    lo = torch.gather(sorted_w, 1, mid[:, None])[:, 0]
    hi = torch.gather(sorted_w, 1, last[:, None])[:, 0]
    med = torch.where(n_valid % 2 == 1, lo, 0.5 * (lo + hi))
    return torch.where(n_valid > 0, med, math.nan)


def mean_filter(x: torch.Tensor, win: int = 3) -> torch.Tensor:
    """NaN-aware sliding mean (torchcrepe.filter.mean)."""
    w = _nan_windows(x, win)
    valid = ~torch.isnan(w)
    s = torch.where(valid, w, 0.0).sum(dim=1)
    n = valid.sum(dim=1)
    return torch.where(n > 0, s / torch.clamp(n, min=1), math.nan)


def a_weighted_loudness(audio: np.ndarray, sample_rate: int, hop_length: int,
                        n_frames: int) -> np.ndarray:
    """Per-frame A-weighted loudness in dBFS (host numpy): the IEC 61672
    A-weighted total energy of each hann-windowed 1024-sample frame,
    referenced to a full-scale sine and floored at -100 dB."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    padded = np.pad(audio, (WINDOW_SIZE // 2, WINDOW_SIZE // 2))
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(WINDOW_SIZE)[None, :])
    idx = np.minimum(idx, len(padded) - 1)
    window = np.hanning(WINDOW_SIZE)
    frames = padded[idx] * window
    mag = np.abs(np.fft.rfft(frames, axis=1)) * (2.0 / window.sum())

    freqs = np.fft.rfftfreq(WINDOW_SIZE, 1.0 / sample_rate)
    f2 = np.maximum(freqs, 1e-6) ** 2
    ra = (12194.0**2 * f2**2) / (
        (f2 + 20.6**2)
        * np.sqrt((f2 + 107.7**2) * (f2 + 737.9**2))
        * (f2 + 12194.0**2)
    )
    a_weight_db = 2.0 + 20.0 * np.log10(np.maximum(ra, 1e-30))

    power = (mag**2) * 10.0 ** (a_weight_db[None, :] / 10.0)
    loudness = 10.0 * np.log10(np.maximum(power.sum(axis=1), 1e-10))
    return np.maximum(loudness, -100.0)


@PITCH_EXTRACTORS.register_module(name="CrepePitchExtractor")
class CrepePitchExtractor(BasePitchExtractor):
    """torchcrepe at 16 kHz, hop 80, on ``device`` (the card unless the
    caller asks for the CPU). ``checkpoint_path`` names a torchcrepe state
    dict (``full.pth``/``tiny.pth``, keys as ``Crepe``'s); without one,
    ``random_init`` draws the weights from ``seed``."""

    def __init__(
        self,
        hop_length: int = 512,
        f0_min: float = 50.0,
        f0_max: float = 1100.0,
        threshold: float = 0.05,
        keep_zeros: bool = False,
        model: str = "full",
        use_fast_filters: bool = True,  # the JAX package's parity kwarg
        checkpoint_path: Optional[str] = None,
        random_init: bool = False,
        seed: int = 0,
        decoder: str = "viterbi",
        device="cuda",
    ):
        super().__init__(hop_length, f0_min, f0_max, keep_zeros)
        if model not in _CAPACITY_CHANNELS:
            raise ValueError(f"CREPE model {model!r}: expected 'full' or 'tiny'")
        if decoder not in ("viterbi", "argmax"):
            raise ValueError(f"CREPE decoder {decoder!r}: expected 'viterbi' or 'argmax'")
        self.threshold = threshold
        self.capacity = model
        self.decoder = decoder
        self.crepe_hop = 80  # 5 ms at 16 kHz
        self.device = resolve_device(device)
        self.model = Crepe(model)
        self.has_weights = False
        if checkpoint_path:
            state = torch.load(checkpoint_path, map_location="cpu")
            self.load_state_dict(state)
        elif random_init:
            self.init_random(seed)
        self.model.to(self.device).eval()
        log_trans = np.log(np.maximum(_transition_matrix(), np.float32(1e-12)))
        self._log_trans = torch.from_numpy(log_trans).to(self.device)

    def load_state_dict(self, state_dict: dict):
        """torchcrepe's keys; BatchNorm's ``num_batches_tracked`` may be
        absent (``convert.crepe_from_jax`` has none)."""
        result = self.model.load_state_dict(state_dict, strict=False)
        missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
        if missing or result.unexpected_keys:
            raise KeyError(f"CREPE state dict: missing {missing}, unexpected "
                           f"{result.unexpected_keys}")
        self.has_weights = True

    def init_random(self, seed: int = 0):
        init_crepe_(self.model, seed)
        self.has_weights = True

    def frame_count(self, n_samples: int, sampling_rate: int) -> int:
        """The 5 ms frames (80 samples at 16 kHz) whose centres lie inside
        ``n_samples`` samples at ``sampling_rate``."""
        n_16k = n_samples * CREPE_SAMPLE_RATE / sampling_rate
        return int(np.ceil(n_16k / self.crepe_hop))

    # -- decode ---------------------------------------------------------------

    def _decode(self, probs: torch.Tensor, n_frames: int):
        """probs [T_bucket, 360] (band-masked, -inf outside, padded past
        ``n_frames``) -> (bins [n], periodicity [n])."""
        real = probs[:n_frames]
        if self.decoder == "viterbi":
            log_obs = torch.log_softmax(probs, dim=1)
            S = probs.shape[1]
            pad_value = -torch.log(torch.tensor(float(S), dtype=torch.float32))
            is_pad = torch.arange(probs.shape[0], device=probs.device) >= n_frames
            log_obs = torch.where(is_pad[:, None], pad_value.to(probs.device), log_obs)
            bins = crepe_viterbi(log_obs[None].contiguous(), self._log_trans)[0, :n_frames]
            bins = bins.long()
        else:
            bins = torch.argmax(real, dim=1)
        salience = torch.where(torch.isneginf(real), 0.0, real)
        periodicity = torch.gather(salience, 1, bins[:, None])[:, 0]
        return bins, periodicity

    def _bins_to_f0(self, bins: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
        """The salience-weighted mean of the cents within +-4 bins of each
        decoded bin -> f0 in Hz."""
        sal = F.pad(torch.where(torch.isneginf(probs), 0.0, probs), (4, 4))
        idx = bins[:, None] + 4 + torch.arange(-4, 5, device=bins.device)[None, :]
        w = torch.gather(sal, 1, idx)
        cents_map = (CENTS_PER_BIN * (torch.arange(PITCH_BINS + 8, device=bins.device) - 4)
                     .float() + CENTS_OFFSET)
        cents = (w * cents_map[idx]).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1e-9)
        return 10.0 * 2.0 ** (cents / 1200.0)

    # -- end to end -----------------------------------------------------------

    @torch.inference_mode()
    def predict_16k(self, audio16k: np.ndarray) -> np.ndarray:
        """Audio at 16 kHz -> f0 [1 + len // 80] at 5 ms frames."""
        if not self.has_weights:
            raise RuntimeError("CREPE has no weights: give checkpoint_path (a "
                               "torchcrepe state dict) or random_init")
        audio16k = np.asarray(audio16k, np.float32).reshape(-1)
        frames = frame_audio_16k(torch.from_numpy(audio16k).to(self.device), self.crepe_hop)
        n_frames = frames.shape[0]
        # a frame bucket (multiple of 256), as the JAX package compiles
        bucket = 256 * ((n_frames - 1) // 256 + 1)
        frames = F.pad(frames, (0, 0, 0, bucket - n_frames))
        probs = self.model(frames)[:n_frames]

        # bins outside [f0_min, f0_max] masked (torchcrepe's postprocess)
        min_bin = max(frequency_to_bin(self.f0_min), 0)
        max_bin = min(frequency_to_bin(self.f0_max, np.ceil), PITCH_BINS)
        masked = torch.full((bucket, PITCH_BINS), -math.inf, device=self.device)
        masked[:n_frames, min_bin:max_bin] = probs[:, min_bin:max_bin]

        bins, pd = self._decode(masked, n_frames)
        f0 = self._bins_to_f0(bins, masked[:n_frames])

        pd = median_filter(pd, 3)
        loudness = a_weighted_loudness(audio16k, CREPE_SAMPLE_RATE, self.crepe_hop, n_frames)
        silent = torch.from_numpy(loudness < -60.0).to(self.device)
        pd = torch.where(silent, 0.0, pd)
        f0 = torch.where(pd < self.threshold, math.nan, f0)
        f0 = mean_filter(f0, 3)
        return torch.where(torch.isnan(f0), 0.0, f0).cpu().numpy()

    def __call__(self, x, sampling_rate=44100, pad_to=None):
        from .feature import resample_linear

        audio = np.asarray(x, np.float32).reshape(-1)
        if sampling_rate != CREPE_SAMPLE_RATE:
            audio = resample_linear(audio, sampling_rate, CREPE_SAMPLE_RATE)
        f0 = self.predict_16k(audio)
        return self.post_process(x, sampling_rate, f0, pad_to)
