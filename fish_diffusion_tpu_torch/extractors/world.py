"""Harvest pitch estimation (``fish_diffusion_tpu/extractors/world.py``).

The WORLD algorithm (Morise 2017, pyworld ``harvest.cpp``) as the JAX
package implements it, stage for stage:

1. a dense bank of band-pass filters (a Nuttall window modulated by a
   cosine at each of ``channels_in_octave`` log-spaced centres per octave)
   applied in frequency space to one FFT of the signal, on a waveform
   decimated by rfft truncation (``_decimation_factor``);
2. per channel, four event-interval period estimates (up and down zero
   crossings, peaks, dips) that must agree with the channel centre within
   +-10% and be backed by channel energy above 0.1 of the frame RMS;
3. per frame, up to four distinct candidates by non-max suppression over
   the channels;
4. each candidate refined by instantaneous frequency over six harmonics
   and scored by the spread of its harmonics' estimates;
5. the contour chosen by the candidate Viterbi (K8-cand,
   ``pitch.viterbi_candidates``), then a 3-frame median fix and log-domain
   smoothing over voiced runs.

FFTs go through ``torch.fft`` (Harvest is not one of the TPU kernels); the
JAX package's ``associative_scan(maximum)`` is ``torch.cummax``,
``jnp.gradient`` is ``torch.gradient`` (first-order edges in both). All
channels run in one batch (the JAX package mapped over chunks of 8 to bound
TPU memory). Arithmetic stays float32 and complex64.

DIO and StoneMask are not ported yet (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..registry import PITCH_EXTRACTORS
from ..utils import resolve_device
from .pitch import BasePitchExtractor, viterbi_candidates


def _decimation_factor(sr: int, f0_max: float, hop_length: int) -> int:
    """Largest power-of-two decimation that keeps >= 6 samples per period
    of ``f0_max`` (and >= 4 kHz) with an integral rate and hop."""
    d = 1
    while (
        sr % (2 * d) == 0
        and hop_length % (2 * d) == 0
        and sr / (2 * d) >= max(4000.0, 6.0 * f0_max)
    ):
        d *= 2
    return d


def _cummax(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    if reverse:
        return torch.cummax(x.flip(-1), dim=-1).values.flip(-1)
    return torch.cummax(x, dim=-1).values


def _interval_f0(sig: torch.Tensor, sr: int) -> torch.Tensor:
    """Per-sample f0 [..., T] from the sub-sample times of the up-crossings
    of ``sig`` that bracket each sample; 0 where no pair brackets it."""
    y0, y1 = sig[..., :-1], sig[..., 1:]
    cross = (y0 < 0) & (y1 >= 0)
    frac = -y0 / torch.clamp(y1 - y0, min=1e-12)
    t_event = torch.arange(sig.shape[-1] - 1, dtype=torch.float32,
                           device=sig.device) + frac

    prev_t = _cummax(torch.where(cross, t_event, -math.inf))
    next_t = -_cummax(torch.where(cross, -t_event, -math.inf), reverse=True)

    interval = next_t - prev_t
    good = torch.isfinite(interval) & (interval > 0)
    f0 = torch.where(good, sr / torch.clamp(interval, min=1e-6), 0.0)
    return torch.cat([f0, f0[..., -1:]], dim=-1)


def _nuttall_bandpass(center_hz: float, sr: int, max_half: int) -> np.ndarray:
    """Band-pass FIR: a Nuttall window over two periods each side,
    modulated by a cosine at ``center_hz``, unit gain at the centre,
    centred in a common ``2 * max_half + 1`` buffer."""
    half = int(round(2.0 * sr / center_hz))
    n = 2 * half + 1
    m = np.arange(n) / (n - 1)
    w = (
        0.355768
        - 0.487396 * np.cos(2 * np.pi * m)
        + 0.144232 * np.cos(4 * np.pi * m)
        - 0.012604 * np.cos(6 * np.pi * m)
    )
    t = np.arange(n) - half
    h = w * np.cos(2 * np.pi * center_hz * t / sr)
    h = h / max(abs(np.sum(h * np.cos(2 * np.pi * center_hz * t / sr))), 1e-9)
    buf = np.zeros(2 * max_half + 1, np.float32)
    buf[max_half - half : max_half + half + 1] = h
    return buf


def _channel_centres(sr_d: int, f0_min: float, f0_max: float,
                     channels_in_octave: int):
    """(centre frequencies [C] float32, the longest filter's half length)."""
    n_ch = max(2, int(math.ceil(math.log2(f0_max / f0_min) * channels_in_octave)))
    boundary = np.asarray(
        [f0_min * 2.0 ** ((i + 1) / channels_in_octave) for i in range(n_ch)],
        np.float32,
    )
    return boundary, int(round(2.0 * sr_d / boundary[0]))


@functools.lru_cache(maxsize=4)
def _bandpass_bank(sr_d: int, f0_min: float, f0_max: float,
                   channels_in_octave: int, nfft_d: int, device: str) -> torch.Tensor:
    """The filter bank's transfer functions [C, nfft_d // 2 + 1] complex64
    on ``device``, designed on the host in float64 once per bucket (the
    host FFTs take about a second at bucket 1024)."""
    boundary, max_half = _channel_centres(sr_d, f0_min, f0_max, channels_in_octave)
    filt = np.stack([_nuttall_bandpass(float(b), sr_d, max_half) for b in boundary])
    return torch.from_numpy(np.fft.rfft(filt, n=nfft_d).astype(np.complex64)).to(device)


def _frame_rms(x: torch.Tensor, centers: torch.Tensor, hop: int) -> torch.Tensor:
    """RMS of the ``hop`` samples around each centre [..., F] (indices
    clamped to the signal)."""
    T = x.shape[-1]
    idx = centers[:, None] + torch.arange(hop, device=x.device)[None, :] - hop // 2
    idx = torch.clamp(idx, 0, T - 1)
    return torch.sqrt(torch.mean(x[..., idx] ** 2, dim=-1))


def _harvest_candidates(x: torch.Tensor, sr: int, hop_length: int,
                        f0_min: float, f0_max: float, channels_in_octave: int):
    """Stages 1-2: (cands [C, F], costs [C, F], frame_rms [F]); cost is the
    four-estimate relative spread, inf where a channel has no candidate."""
    dev = x.device
    T = x.shape[0]
    n_frames = T // hop_length + 1
    centers = torch.clamp(torch.arange(n_frames, device=dev) * hop_length, max=T - 1)

    D = _decimation_factor(sr, f0_max, hop_length)
    sr_d = sr // D
    T_d = -(-T // D)
    hop_d = hop_length // D
    centers_d = torch.clamp(torch.arange(n_frames, device=dev) * hop_d, max=T_d - 1)

    boundary, max_half = _channel_centres(sr_d, f0_min, f0_max, channels_in_octave)
    nfft_d = 1 << int(math.ceil(math.log2(T_d + 2 * max_half + 1)))
    X = torch.fft.rfft(x, n=nfft_d * D)
    X_d = X[: nfft_d // 2 + 1] / D  # band-limited decimation

    H = _bandpass_bank(sr_d, f0_min, f0_max, channels_in_octave, nfft_d, str(dev))
    bounds = torch.from_numpy(boundary).to(dev)[:, None]

    frame_rms = _frame_rms(x, centers, hop_length)

    y = torch.fft.irfft(X_d[None, :] * H, n=nfft_d)[:, max_half : max_half + T_d]
    dy = torch.diff(y, dim=1, append=y[:, -1:])
    ests = torch.stack([_interval_f0(y, sr_d), _interval_f0(-y, sr_d),
                        _interval_f0(dy, sr_d), _interval_f0(-dy, sr_d)], dim=1)
    ests_f = ests[:, :, centers_d]
    ests_n = ests[:, :, torch.clamp(centers_d + 1, max=T_d - 1)]
    ests_f = torch.where(ests_f > 0, ests_f, ests_n)  # a centre on an event
    means = ests_f.mean(dim=1)
    spreads = torch.sqrt(torch.clamp(
        ((ests_f - means[:, None, :]) ** 2).mean(dim=1), min=0.0))
    # a candidate needs a real spectral component in its band: narrowband
    # noise also oscillates at the channel centre with agreeing intervals
    ch_amps = _frame_rms(y, centers_d, hop_d)

    ok = (
        (means > 0)
        & (means >= 0.9 * bounds)
        & (means <= 1.1 * bounds)
        & (means >= f0_min)
        & (means <= f0_max)
        & (ch_amps > 0.1 * frame_rms[None, :])
    )
    cands = torch.where(ok, means, 0.0)
    costs = torch.where(ok, spreads / torch.clamp(means, min=1e-6), math.inf)
    return cands, costs, frame_rms


def _harvest_nms(cands: torch.Tensor, costs: torch.Tensor, k: int = 4):
    """Stage 3: the ``k`` best distinct candidates per frame, suppressing
    +-10% neighbours after each pick -> (cand_k [k, F], cost_k [k, F])."""
    idx = torch.arange(cands.shape[1], device=cands.device)
    picks_c, picks_s = [], []
    for _ in range(k):
        best = torch.argmin(costs, dim=0)
        c = cands[best, idx]
        s = costs[best, idx]
        picks_c.append(torch.where(torch.isfinite(s), c, 0.0))
        picks_s.append(s)
        close = (cands - c[None, :]).abs() <= 0.1 * torch.clamp(c[None, :], min=1e-6)
        costs = torch.where(close, math.inf, costs)
        cands = torch.where(close, 0.0, cands)
    return torch.stack(picks_c), torch.stack(picks_s)


def _if_estimate(frames, t_rel, sr: int, f_cur, n_harmonics: int):
    """One instantaneous-frequency pass: the amplitude-weighted mean of
    IF_k / k over the harmonics and the weighted absolute deviation from it.
    frames [F, L], t_rel [L] seconds, f_cur [F] -> (refined [F], dev [F])."""
    period = 1.0 / f_cur
    arg = t_rel[None, :] / (3.0 * period[:, None])  # Hann over +-1.5 periods
    w = torch.where(arg.abs() < 0.5, 0.5 + 0.5 * torch.cos(2 * math.pi * arg), 0.0)
    wx = w * frames
    dwx = torch.gradient(wx, dim=1)[0] * sr

    ifs, amps = [], []
    for k in range(1, n_harmonics + 1):
        fk = k * f_cur
        ph = -2 * math.pi * fk[:, None] * t_rel[None, :]
        c, s = torch.cos(ph), torch.sin(ph)
        xr = (wx * c).sum(dim=1)
        xi = (wx * s).sum(dim=1)
        yr = (dwx * c).sum(dim=1)
        yi = (dwx * s).sum(dim=1)
        power = xr * xr + xi * xi
        if_hz = (xr * yi - xi * yr) / (2 * math.pi * torch.clamp(power, min=1e-12))
        # the centred difference attenuates a tone's derivative by
        # sinc(w dt); correct at the evaluation frequency
        wdt = 2 * math.pi * fk / sr
        if_hz = if_hz * wdt / torch.sin(torch.clamp(wdt, max=3.0))
        amp = torch.sqrt(torch.clamp(power, min=0.0))
        amp = torch.where(fk < 0.5 * sr, amp, 0.0)
        ifs.append(if_hz / k)
        amps.append(amp)

    ifs, amps = torch.stack(ifs), torch.stack(amps)
    den = torch.clamp(amps.sum(dim=0), min=1e-12)
    refined = (amps * ifs).sum(dim=0) / den
    dev = (amps * (ifs - refined[None, :]).abs()).sum(dim=0) / den
    return refined, dev


def _harvest_refine(x: torch.Tensor, sr: int, cand_k: torch.Tensor,
                    centers_hop: int, f0_min: float, n_harmonics: int = 6):
    """Stage 4: each candidate refined twice by instantaneous frequency and
    scored by its harmonics' relative deviation (lower is more reliable).
    cand_k [K, F] (0 = none) -> (refined [K, F], score [K, F])."""
    T = x.shape[0]
    F = cand_k.shape[1]
    L = int(3.0 * sr / f0_min)
    L += L % 2
    half = L // 2

    dev = x.device
    centers = torch.clamp(torch.arange(F, device=dev) * centers_hop, max=T - 1)
    xpad = torch.nn.functional.pad(x, (half, half))
    frames = xpad[centers[:, None] + torch.arange(L, device=dev)[None, :]]
    t_rel = (torch.arange(L, dtype=torch.float32, device=dev) - half) / sr

    refined, scores = [], []
    for f0 in cand_k:
        f_safe = torch.clamp(f0, min=f0_min)
        r1, _ = _if_estimate(frames, t_rel, sr, f_safe, n_harmonics)
        r1 = torch.where((r1 > 0.5 * f_safe) & (r1 < 2.0 * f_safe), r1, f_safe)
        r2, dev_ = _if_estimate(frames, t_rel, sr, r1, n_harmonics)
        good = (f0 > 0) & (r2 > 0) & ((r2 - f0).abs() <= 0.12 * f0)
        refined.append(torch.where(good, r2, 0.0))
        scores.append(torch.where(good, dev_ / torch.clamp(r2, min=1e-6), math.inf))
    return torch.stack(refined), torch.stack(scores)


def _neighbours(f0: torch.Tensor):
    return (torch.cat([f0[:1], f0[:-1]]), torch.cat([f0[1:], f0[-1:]]))


def _harvest_finalize(cand_k, score_k, frame_rms, f0_min: float = 50.0,
                      score_scale: float = 6.0, silence_threshold: float = 0.005):
    """Stage 5: the contour by the candidate Viterbi (a small preference for
    low f0, praat's octave cost, breaks the tie between f0 and 2 f0), a
    3-frame median fix, and 3-tap log-domain smoothing inside voiced runs."""
    valid = torch.isfinite(score_k) & (cand_k > 0)
    strength = (
        1.0
        - score_scale * torch.clamp(torch.where(valid, score_k, 1.0), max=1.0)
        - 0.05 * torch.log2(torch.clamp(cand_k, min=1e-6) / f0_min)
    )
    strength = torch.where(valid, strength, -1.0)
    # the unvoiced state wins outright in silence and competes at 0.45
    unvoiced = torch.where(frame_rms > silence_threshold, 0.45, 2.0)
    f0, _ = viterbi_candidates(cand_k.T.contiguous()[None],
                               strength.T.contiguous()[None], unvoiced[None])
    f0 = f0[0]

    left, right = _neighbours(f0)
    med = torch.median(torch.stack([left, f0, right]), dim=0).values
    f0 = torch.where((f0 - med).abs() <= 0.15 * torch.clamp(med, min=1e-6), f0, 0.0)

    left, right = _neighbours(f0)
    lf = torch.log(torch.clamp(f0, min=1e-6))
    lfl = torch.log(torch.clamp(left, min=1e-6))
    lfr = torch.log(torch.clamp(right, min=1e-6))
    inner = (f0 > 0) & (left > 0) & (right > 0)
    sm = torch.exp(0.25 * lfl + 0.5 * lf + 0.25 * lfr)
    return torch.where(inner, sm, f0)


def harvest_f0(x: torch.Tensor, sr: int, hop_length: int, f0_min: float,
               f0_max: float, channels_in_octave: int) -> torch.Tensor:
    """The whole Harvest pipeline: x [T] float32 -> f0 [T // hop + 1]."""
    cands, costs, frame_rms = _harvest_candidates(
        x, sr, hop_length, f0_min, f0_max, channels_in_octave
    )
    cand_k, _ = _harvest_nms(cands, costs)
    refined, score = _harvest_refine(x, sr, cand_k, hop_length, f0_min)
    return _harvest_finalize(refined, score, frame_rms, f0_min)


@PITCH_EXTRACTORS.register_module(name="HarvestPitchExtractor")
class HarvestPitchExtractor(BasePitchExtractor):
    """Harvest on ``device`` (the card unless the caller asks for the CPU):
    host audio -> f0 [T // hop + 1] (or ``post_process``-ed to ``pad_to``
    frames), numpy float32."""

    def __init__(self, channels_in_octave: int = 24, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.channels_in_octave = channels_in_octave
        self.device = resolve_device(device)

    @torch.inference_mode()
    def __call__(self, x, sampling_rate=44100, pad_to=None):
        x = torch.as_tensor(np.asarray(x, np.float32).reshape(-1), device=self.device)
        f0 = harvest_f0(x, int(sampling_rate), self.hop_length,
                        float(self.f0_min), float(self.f0_max),
                        self.channels_in_octave)
        return self.post_process(x, sampling_rate, f0.cpu().numpy(), pad_to)
