"""Pitch extractors (``fish_diffusion_tpu/extractors/pitch.py``).

``BasePitchExtractor.post_process`` stretches an f0 curve to the mel frame
count and, unless ``keep_zeros``, fills unvoiced frames by linear
interpolation over the voiced ones (host numpy, as in the JAX package);
``frame_count`` says how many of an extractor's frames cover a segment.

- ``viterbi_candidates``: praat's path finder over per-frame pitch
  candidates, which Harvest and ParselMouth run on every segment. Its
  forward recursion and backtrack are K8-cand, the hand-written CUDA kernel
  of ``csrc/viterbi.cu``.
- ``pyin_viterbi`` and ``crepe_viterbi``: the max-product decode over a
  dense [S, S] log-transition matrix (pYIN: 2 x 215 states, CREPE: 360),
  both K8 dense, the CUDA kernel of ``csrc/viterbi_dense.cu``.
- ``YinPitchExtractor`` (YIN), ``AutocorrPitchExtractor`` (praat-style
  window-corrected autocorrelation, registered again as
  ``ParselMouthPitchExtractor``) and ``PyinPitchExtractor`` (probabilistic
  YIN with its HMM). Their frame stages are torch on the device, FFTs
  through ``torch.fft``.

Every kernel wrapper takes its plain version (``*_reference``) for CPU
tensors. RMVPE is the one pitch extractor of the JAX package that is not
ported yet (ROADMAP Queue 1, The rest: RMVPE).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..ops.tensor import repeat_expand_np
from ..registry import PITCH_EXTRACTORS
from ..utils import resolve_device

OCTAVE_JUMP_COST = 0.35
VOICED_UNVOICED_COST = 0.14


class BasePitchExtractor:
    def __init__(
        self,
        hop_length: int = 512,
        f0_min: float = 50.0,
        f0_max: float = 1100.0,
        keep_zeros: bool = True,
    ):
        self.hop_length = hop_length
        self.f0_min = f0_min
        self.f0_max = f0_max
        self.keep_zeros = keep_zeros

    def __call__(self, x, sampling_rate=44100, pad_to=None):
        raise NotImplementedError

    def frame_count(self, n_samples: int, sampling_rate: int) -> int:
        """The frames of this extractor that cover ``n_samples`` samples of
        audio (one per ``hop_length``, as the JAX server crops)."""
        return int(np.ceil(n_samples / self.hop_length))

    def post_process(self, x, sampling_rate, f0, pad_to):
        """f0 [T] -> [pad_to] (nearest stretch); unless ``keep_zeros``,
        unvoiced frames take ``np.interp`` over the voiced ones (the ends
        extend the first and last voiced values)."""
        f0 = np.asarray(f0, np.float32)
        if pad_to is None:
            return f0

        f0 = repeat_expand_np(f0, pad_to)
        if self.keep_zeros:
            return f0

        nzindex = np.nonzero(f0)[0]
        f0_nz = f0[nzindex]
        if len(f0_nz) == 0:
            return np.zeros(pad_to, np.float32)
        if len(f0_nz) == 1:
            return np.full(pad_to, f0_nz[0], np.float32)

        time_org = self.hop_length / sampling_rate * nzindex
        time_frame = np.arange(pad_to) * self.hop_length / sampling_rate
        return np.interp(time_frame, time_org, f0_nz).astype(np.float32)


# ---------------------------------------------------------------------------
# K8-cand: the candidate Viterbi
# ---------------------------------------------------------------------------


def _states(freqs, strengths, unvoiced):
    """Append the unvoiced state: (f_all, str_all) [B, T, K + 1]."""
    zeros = torch.zeros_like(unvoiced)[..., None]
    return (torch.cat([freqs, zeros], dim=-1),
            torch.cat([strengths, unvoiced[..., None]], dim=-1))


def viterbi_candidates_reference(freqs, strengths, unvoiced):
    """Plain version of K8-cand. freqs, strengths [B, T, K], unvoiced
    [B, T] -> (f0 [B, T] float32, path [B, T] int32). Ties take the first
    state, as ``torch.max`` and ``jnp.argmax`` do."""
    f_all, str_all = _states(freqs, strengths, unvoiced)
    B, T, S = f_all.shape
    lp = torch.log2(torch.clamp(f_all, min=1e-6))
    voiced = f_all > 0
    # cost[b, t - 1, i, j]: from state i at frame t - 1 to state j at frame t
    jump = (lp[:, :-1, :, None] - lp[:, 1:, None, :]).abs()
    vp, vn = voiced[:, :-1, :, None], voiced[:, 1:, None, :]
    cost = torch.where(vp & vn, OCTAVE_JUMP_COST * jump,
                       torch.where(vp ^ vn, VOICED_UNVOICED_COST, 0.0))

    delta = str_all[:, 0]
    backptrs = []
    for t in range(1, T):
        best, arg = torch.max(delta[:, :, None] - cost[:, t - 1], dim=1)
        delta = best + str_all[:, t]
        backptrs.append(arg)

    bp = torch.stack(backptrs, 1).cpu().numpy() if backptrs else None
    path = np.zeros((B, T), np.int64)
    path[:, -1] = torch.argmax(delta, dim=1).cpu().numpy()
    rows = np.arange(B)
    for t in range(T - 1, 0, -1):
        path[:, t - 1] = bp[rows, t - 1, path[:, t]]
    path_t = torch.from_numpy(path).to(f_all.device)
    f0 = torch.gather(f_all, 2, path_t[..., None])[..., 0]
    return f0, path_t.int()


def viterbi_candidates(freqs, strengths, unvoiced):
    """K8-cand: the candidate path and its f0. freqs, strengths [B, T, K],
    unvoiced [B, T], float32 -> (f0 [B, T], path [B, T] int32). CPU tensors
    take ``viterbi_candidates_reference``."""
    if not freqs.is_cuda:
        return viterbi_candidates_reference(freqs, strengths, unvoiced)
    out = _viterbi_candidates(freqs, strengths, unvoiced)
    kernels.count_launch("viterbi_candidates")
    return out


def _viterbi_candidates(freqs, strengths, unvoiced, entry: str = "viterbi_candidates"):
    """K8-cand's kernel on CUDA tensors, uncounted.
    ``entry="viterbi_candidates_chain"`` launches the same kernel with each
    frame's exchange, tree and add on costs held in registers (the chain
    floor of a measurement; path and f0 are not written)."""
    kernels.require_cuda("viterbi_candidates", freqs, strengths, unvoiced)
    if freqs.dtype != torch.float32:
        raise TypeError(f"viterbi_candidates: takes float32, got {freqs.dtype}")
    if freqs.ndim != 3 or strengths.shape != freqs.shape \
            or unvoiced.shape != freqs.shape[:2]:
        raise ValueError(
            f"viterbi_candidates: freqs {tuple(freqs.shape)}, strengths "
            f"{tuple(strengths.shape)}, unvoiced {tuple(unvoiced.shape)}: "
            "expected [B, T, K], [B, T, K], [B, T]"
        )
    B, T, K = freqs.shape
    if not 1 <= K <= 31 or T < 1:
        raise ValueError(f"viterbi_candidates: K = {K}, T = {T}: needs "
                         "1 <= K <= 31 candidates and a frame")
    dev = freqs.device
    lib = kernels.load_library("viterbi")
    per_item = lib.viterbi_candidates_plan(T, K, 2)
    if per_item < 0:
        raise ValueError(f"viterbi_candidates: no plan for T = {T}, K = {K}")
    scratch = torch.empty(B * per_item, dtype=torch.uint8, device=dev) if per_item else None
    path = torch.empty((B, T), dtype=torch.int32, device=dev)
    f0 = torch.empty((B, T), dtype=torch.float32, device=dev)
    kernels.check(
        getattr(lib, entry)(freqs.data_ptr(), strengths.data_ptr(), unvoiced.data_ptr(),
                            None if scratch is None else scratch.data_ptr(),
                            path.data_ptr(), f0.data_ptr(), B, T, K, kernels.stream()),
        "viterbi_candidates",
    )
    return f0, path


# ---------------------------------------------------------------------------
# Frames, YIN's difference function, the window-corrected ACF
# ---------------------------------------------------------------------------


def _rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` by true division (``float / tensor`` in torch multiplies
    by the reciprocal, which rounds differently from the JAX package)."""
    return torch.as_tensor(num, dtype=t.dtype, device=t.device) / t


def _frame_signal(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """[T] -> [n_frames, frame_length], centred (reflect pad)."""
    pad = frame_length // 2
    x = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    return x.unfold(0, frame_length, hop_length)


def _lag_band(sr: int, half: int, f0_min: float, f0_max: float, device):
    """(taus [half + 1], band [half + 1]): the lags and the mask of those in
    ``[max(sr // f0_max, 1), min(sr // f0_min + 1, half))``."""
    tau_min, tau_max = max(int(sr / f0_max), 1), min(int(sr / f0_min) + 1, half)
    taus = torch.arange(half + 1, device=device)
    return taus, (taus >= tau_min) & (taus < tau_max)


def _parabolic(y0, y1, y2):
    """Sub-lag offset of a parabola through three points, in [-1, 1]."""
    denom = y0 - 2 * y1 + y2
    ok = denom.abs() > 1e-12
    offset = torch.where(ok, 0.5 * (y0 - y2) / torch.where(ok, denom, 1.0), 0.0)
    return torch.clamp(offset, -1.0, 1.0)


def _yin_cmnd(frames: torch.Tensor):
    """YIN's cumulative-mean-normalised difference [F, W // 2 + 1] (the
    difference function from the FFT autocorrelation and the prefix
    energies) and the frames' squares."""
    n_frames, W = frames.shape
    half = W // 2
    spec = torch.fft.rfft(frames, n=2 * W, dim=-1)
    acf = torch.fft.irfft(spec * spec.conj(), n=2 * W, dim=-1)[:, : half + 1]
    sq = frames * frames
    csum = F.pad(torch.cumsum(sq, dim=-1), (1, 0))
    taus = torch.arange(half + 1, device=frames.device)
    # d(tau) = energy of x[0 .. W - tau) + energy of x[tau .. W) - 2 acf(tau)
    d = csum[:, W - taus] + (csum[:, W:] - csum[:, taus]) - 2 * acf
    cum = torch.cumsum(d[:, 1:], dim=-1)
    cmnd = torch.cat([torch.ones_like(d[:, :1]),
                      d[:, 1:] * taus[1:] / torch.clamp(cum, min=1e-9)], dim=-1)
    return cmnd, sq


def _yin_f0(x, sampling_rate: int, frame_length: int, hop_length: int,
            f0_min: float, f0_max: float, threshold: float = 0.15):
    """YIN: x [T] -> f0 [n_frames] (0 = unvoiced). The first local minimum
    of the CMND below ``threshold`` (else the global minimum) inside the
    lag band, refined by a parabola."""
    frames = _frame_signal(x, frame_length, hop_length)
    half = frames.shape[1] // 2
    _, band = _lag_band(sampling_rate, half, f0_min, f0_max, x.device)
    cmnd, sq = _yin_cmnd(frames)
    cmnd_band = torch.where(band, cmnd, math.inf)
    next_val = F.pad(cmnd_band[:, 1:], (0, 1), value=math.inf)
    below = (cmnd_band < threshold) & (cmnd_band <= next_val)
    any_below = below.any(dim=-1)
    tau_star = torch.where(any_below, torch.argmax(below.int(), dim=-1),
                           torch.argmin(cmnd_band, dim=-1))

    def at(t):
        return torch.gather(cmnd, 1, torch.clamp(t, 0, half)[:, None])[:, 0]

    offset = _parabolic(at(tau_star - 1), at(tau_star), at(tau_star + 1))
    f0 = _rdiv(float(sampling_rate), torch.clamp(tau_star + offset, min=1e-6))
    voiced = any_below & (torch.sqrt(sq.mean(dim=-1)) > 1e-4)
    f0 = torch.where(voiced, f0, 0.0)
    return torch.where((f0 >= f0_min) & (f0 <= f0_max), f0, 0.0)


def _acf_score(x, sampling_rate: int, frame_length: int, hop_length: int,
               f0_min: float):
    """The hann-windowed frames' autocorrelation divided by the window's
    own (Boersma's correction), r [F, W // 2 + 1]; praat's octave-cost
    score of each lag; the frames' RMS [F]."""
    frames = _frame_signal(x, frame_length, hop_length)
    n_frames, W = frames.shape
    half = W // 2
    frames = frames - frames.mean(dim=-1, keepdim=True)
    window = torch.from_numpy(np.hanning(W).astype(np.float32)).to(x.device)

    spec = torch.fft.rfft(frames * window, n=2 * W, dim=-1)
    acf = torch.fft.irfft(spec * spec.conj(), n=2 * W, dim=-1)[:, : half + 1]
    acf_norm = acf / torch.clamp(acf[:, :1], min=1e-9)
    wspec = torch.fft.rfft(window, n=2 * W)
    wacf = torch.fft.irfft(wspec * wspec.conj(), n=2 * W)[: half + 1]
    r = acf_norm / torch.clamp(wacf / torch.clamp(wacf[0], min=1e-9), min=1e-3)

    taus = torch.arange(half + 1, device=x.device)
    lag_sec = torch.clamp(taus, min=1).float() / sampling_rate
    score = r - 0.01 * torch.log2(torch.clamp(f0_min * lag_sec, min=1e-9))
    return r, score, torch.sqrt(torch.mean(frames * frames, dim=-1))


_N_CANDIDATES = 4  # voiced candidates per frame for the candidate Viterbi


def _acf_candidates(x, sampling_rate: int, frame_length: int, hop_length: int,
                    f0_min: float, f0_max: float, voicing_threshold: float = 0.45):
    """Praat's candidate stage (Boersma 1993): the ``_N_CANDIDATES`` best
    local maxima of the corrected ACF in the lag band, each refined by a
    parabola, and the unvoiced candidate's strength. -> (freqs [F, K],
    strengths [F, K], unvoiced [F]); an empty candidate has frequency 0 and
    strength -1."""
    r, score, frame_rms = _acf_score(x, sampling_rate, frame_length, hop_length, f0_min)
    half = r.shape[1] - 1
    _, band = _lag_band(sampling_rate, half, f0_min, f0_max, x.device)

    left = F.pad(score[:, :-1], (1, 0), value=-math.inf)
    right = F.pad(score[:, 1:], (0, 1), value=-math.inf)
    peak_score = torch.where((score >= left) & (score > right) & band, score, -math.inf)
    # jax.lax.top_k: the lower index first among equal scores (the -inf
    # scores of frames with few peaks tie): a stable descending sort
    top_scores, top_taus = torch.sort(peak_score, dim=-1, descending=True, stable=True)
    top_scores, top_taus = top_scores[:, :_N_CANDIDATES], top_taus[:, :_N_CANDIDATES]

    def at(t):
        return torch.gather(r, 1, torch.clamp(t, 0, half))

    offset = _parabolic(at(top_taus - 1), at(top_taus), at(top_taus + 1))
    freqs = _rdiv(float(sampling_rate), torch.clamp(top_taus + offset, min=1e-6))
    found = torch.isfinite(top_scores)
    valid = found & (freqs >= f0_min) & (freqs <= f0_max)
    strengths = torch.where(valid, torch.where(found, at(top_taus), -1.0), -1.0)
    freqs = torch.where(valid, freqs, 0.0)

    # praat: VoicingThreshold + max(0, 2 - intensity ratio), the intensity
    # proxied by frame RMS against a -40 dBFS floor
    intensity = frame_rms / 0.01
    unvoiced = voicing_threshold + torch.clamp(
        2.0 - intensity / (1.0 + voicing_threshold), min=0.0)
    return freqs, strengths, unvoiced


def _autocorr_f0(x, sampling_rate: int, frame_length: int, hop_length: int,
                 f0_min: float, f0_max: float, voicing_threshold: float = 0.45):
    """Per-frame best lag of the octave-cost score, refined by a parabola,
    voiced where its corrected ACF exceeds ``voicing_threshold``."""
    r, score, frame_rms = _acf_score(x, sampling_rate, frame_length, hop_length, f0_min)
    half = r.shape[1] - 1
    _, band = _lag_band(sampling_rate, half, f0_min, f0_max, x.device)
    tau_star = torch.argmax(torch.where(band, score, -math.inf), dim=-1)

    def at(t):
        return torch.gather(r, 1, torch.clamp(t, 0, half)[:, None])[:, 0]

    r_star = at(tau_star)
    offset = _parabolic(at(tau_star - 1), r_star, at(tau_star + 1))
    f0 = _rdiv(float(sampling_rate), torch.clamp(tau_star + offset, min=1e-6))
    voiced = (r_star > voicing_threshold) & (frame_rms > 1e-4)
    f0 = torch.where(voiced, f0, 0.0)
    return torch.where((f0 >= f0_min) & (f0 <= f0_max), f0, 0.0)


class DeviceExtractor(BasePitchExtractor):
    """An extractor whose ``f0`` runs on ``device`` (the card unless the
    caller asks for the CPU): host audio -> f0 [T // hop + 1] (or
    ``post_process``-ed to ``pad_to`` frames), numpy float32."""

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def f0(self, x: torch.Tensor, sampling_rate: int) -> torch.Tensor:
        raise NotImplementedError

    @torch.inference_mode()
    def __call__(self, x, sampling_rate=44100, pad_to=None):
        x = torch.as_tensor(np.asarray(x, np.float32).reshape(-1), device=self.device)
        f0 = self.f0(x, int(sampling_rate))
        return self.post_process(x, sampling_rate, f0.cpu().numpy(), pad_to)


class _FramedExtractor(DeviceExtractor):
    """The frame-based extractors of this module: ``frame_length``-sample
    frames every ``hop_length``, lags in [sr / f0_max, sr / f0_min]."""

    def __init__(self, frame_length: int = 2048, device="cuda", **kwargs):
        super().__init__(device, **kwargs)
        self.frame_length = frame_length

    def _band(self):
        return self.frame_length, self.hop_length, float(self.f0_min), float(self.f0_max)


@PITCH_EXTRACTORS.register_module()
class YinPitchExtractor(_FramedExtractor):
    """YIN (de Cheveigne and Kawahara 2002): ``_yin_f0``."""

    def __init__(self, frame_length: int = 2048, threshold: float = 0.15, device="cuda",
                 **kwargs):
        super().__init__(frame_length, device, **kwargs)
        self.threshold = threshold

    def f0(self, x, sampling_rate):
        return _yin_f0(x, sampling_rate, *self._band(), float(self.threshold))


@PITCH_EXTRACTORS.register_module()
class AutocorrPitchExtractor(_FramedExtractor):
    """Praat-style autocorrelation pitch. ``use_viterbi`` (the default)
    decodes praat's candidates (``_acf_candidates``) with the candidate
    Viterbi (K8-cand); ``False`` takes each frame's best lag
    (``_autocorr_f0``)."""

    def __init__(self, frame_length: int = 2048, voicing_threshold: float = 0.45,
                 use_viterbi: bool = True, device="cuda", **kwargs):
        super().__init__(frame_length, device, **kwargs)
        self.voicing_threshold = voicing_threshold
        self.use_viterbi = use_viterbi

    def f0(self, x, sampling_rate):
        band = (*self._band(), float(self.voicing_threshold))
        if not self.use_viterbi:
            return _autocorr_f0(x, sampling_rate, *band)
        freqs, strengths, unvoiced = _acf_candidates(x, sampling_rate, *band)
        return viterbi_candidates(freqs[None].contiguous(), strengths[None].contiguous(),
                                  unvoiced[None].contiguous())[0][0]


@PITCH_EXTRACTORS.register_module(name="ParselMouthPitchExtractor")
class ParselMouthPitchExtractor(AutocorrPitchExtractor):
    """The configs' name for ``AutocorrPitchExtractor`` (praat's
    ``to_pitch_ac``, as the JAX package implements it)."""


# ---------------------------------------------------------------------------
# K8 dense: the Viterbi decoder of pYIN and CREPE
# ---------------------------------------------------------------------------


def viterbi_dense_reference(delta0, log_obs, log_A):
    """Plain version of K8 dense. delta0 [B, S], log_obs [B, T, S], log_A
    [S, S] (from i to j) -> path [B, T] int32:
    delta_t[j] = max_i (delta_{t-1}[i] + A[i, j]) + obs_t[j] for t >= 1,
    the path ending at the first argmax of delta_{T-1}. Ties take the first
    state, as ``torch.max`` and ``jnp.argmax`` do; the backtrack runs on
    the host."""
    B, T, S = log_obs.shape
    delta = delta0
    backptrs = []
    for t in range(1, T):
        best, arg = torch.max(delta[:, :, None] + log_A, dim=1)
        delta = best + log_obs[:, t]
        backptrs.append(arg)
    bp = torch.stack(backptrs, 1).cpu().numpy() if backptrs else None
    path = np.zeros((B, T), np.int64)
    path[:, -1] = torch.argmax(delta, dim=1).cpu().numpy()
    rows = np.arange(B)
    for t in range(T - 1, 0, -1):
        path[:, t - 1] = bp[rows, t - 1, path[:, t]]
    return torch.from_numpy(path).to(log_obs.device).int()


def pyin_delta0(log_obs):
    """pYIN's first frame: delta_0 = obs_0 (``_pyin_viterbi``)."""
    return log_obs[:, 0].contiguous()


def crepe_delta0(log_obs):
    """CREPE's first frame: delta_0 = -log(S) + obs_0, the uniform initial
    distribution with its constant formed in float32 (``_viterbi_path``).
    The constant goes in as a Python scalar (exact in float32), so a CUDA
    call copies nothing from the host and does not wait for the card."""
    S = log_obs.shape[-1]
    init = float(-torch.log(torch.tensor(float(S), dtype=torch.float32)))
    return (log_obs[:, 0] + init).contiguous()


def dense_backptr_shape(B: int, T: int, S: int):
    """K8 dense's backpointer scratch: [B, T - 1, S] int16 with each row
    padded to a multiple of 8 states (16 bytes, which the backtrack's
    copies move); one row where T = 1."""
    return (B, max(T - 1, 1), (S + 7) // 8 * 8)


def _viterbi_dense(name: str, delta0, log_obs, log_A, entry: str = "viterbi_dense"):
    """K8 dense under launch name ``name``: the cluster kernel on CUDA
    tensors (it raises if the build, the launch or the cluster's scheduling
    fails), the plain version on CPU ones. ``entry="viterbi_dense_chain"``
    launches the same kernel with an empty frame body (the chain floor of a
    measurement; not a decode, not counted)."""
    if not log_obs.is_cuda:
        return viterbi_dense_reference(delta0, log_obs, log_A)
    kernels.require_cuda(name, delta0, log_obs, log_A)
    if log_obs.dtype != torch.float32:
        raise TypeError(f"{name}: takes float32, got {log_obs.dtype}")
    if log_obs.ndim != 3:
        raise ValueError(f"{name}: log_obs {tuple(log_obs.shape)}: expected [B, T, S]")
    B, T, S = log_obs.shape
    if delta0.shape != (B, S) or log_A.shape != (S, S):
        raise ValueError(f"{name}: delta0 {tuple(delta0.shape)}, log_A "
                         f"{tuple(log_A.shape)}: expected [{B}, {S}], [{S}, {S}]")
    if not 1 <= S <= 512 or T < 1:
        raise ValueError(f"{name}: S = {S}, T = {T}: needs 1 <= S <= 512 states "
                         "and a frame")
    dev = log_obs.device
    backptr = torch.empty(dense_backptr_shape(B, T, S), dtype=torch.int16, device=dev)
    path = torch.empty((B, T), dtype=torch.int32, device=dev)
    lib = kernels.load_library("viterbi_dense")
    kernels.check(
        getattr(lib, entry)(delta0.data_ptr(), log_obs.data_ptr(), log_A.data_ptr(),
                            backptr.data_ptr(), path.data_ptr(), B, T, S,
                            kernels.stream()),
        name,
    )
    if entry == "viterbi_dense":
        kernels.count_launch(name)
    return path


def pyin_viterbi(log_obs, log_A):
    """K8 pYIN: the state path [B, T] int32 of log_obs [B, T, S] under the
    dense log-transition matrix log_A [S, S], from delta_0 = obs_0."""
    return _viterbi_dense("pyin_viterbi", pyin_delta0(log_obs), log_obs, log_A)


def crepe_viterbi(log_obs, log_A):
    """K8 CREPE: as ``pyin_viterbi`` from a uniform initial distribution;
    -inf observations (masked bins) pass through."""
    return _viterbi_dense("crepe_viterbi", crepe_delta0(log_obs), log_obs, log_A)


# ---------------------------------------------------------------------------
# pYIN
# ---------------------------------------------------------------------------

_PYIN_K = 8  # YIN troughs kept per frame (the prefix-minima staircase)


def _beta_cdf_grid(a: float, b: float, n: int = 512) -> np.ndarray:
    """CDF of Beta(a, b) tabulated on [0, 1] (host side)."""
    from scipy.special import betainc

    return betainc(a, b, np.linspace(0.0, 1.0, n)).astype(np.float32)


def _pyin_observations(x, sampling_rate: int, frame_length: int, hop_length: int,
                       f0_min: float, f0_max: float, beta_cdf: torch.Tensor,
                       no_trough_prob: float = 0.01):
    """pYIN's observation stage (Mauch and Dixon 2014): YIN's CMND per
    frame -> up to ``_PYIN_K`` candidate troughs with their probability
    under a Beta prior over the YIN threshold, in closed form: the possible
    "first trough below s" winners are the prefix-minima staircase of the
    troughs, and staircase trough c (value v_c, the previous step v_prev,
    1 for the first) takes CDF(v_prev) - CDF(v_c); thresholds below every
    trough give the deepest one ``no_trough_prob`` of their mass.
    -> (freqs [F, K], probs [F, K]), 0 where a candidate is empty."""
    frames = _frame_signal(x, frame_length, hop_length)
    n_frames, W = frames.shape
    half = W // 2
    dev = x.device
    taus, band = _lag_band(sampling_rate, half, f0_min, f0_max, dev)
    cmnd, _ = _yin_cmnd(frames)

    prev_v = F.pad(cmnd[:, :-1], (1, 0), value=math.inf)
    next_v = F.pad(cmnd[:, 1:], (0, 1), value=math.inf)
    is_trough = (cmnd <= prev_v) & (cmnd < next_v) & band
    tval = torch.where(is_trough, cmnd, math.inf)

    # a trough is a possible "first below s" iff it is strictly lower than
    # every earlier trough
    run_min = torch.cummin(tval, dim=1).values
    prev_run_min = F.pad(run_min[:, :-1], (1, 0), value=math.inf)
    on_stair = is_trough & (tval < prev_run_min)

    # the first K staircase troughs, ordered by lag; the rest go to column
    # K, which is dropped
    stair_rank = torch.cumsum(on_stair, dim=1) - 1
    scat = torch.where(on_stair & (stair_rank < _PYIN_K), stair_rank, _PYIN_K)
    cand_tau = torch.full((n_frames, _PYIN_K + 1), -1, dtype=torch.long, device=dev)
    cand_tau = cand_tau.scatter(1, scat, taus.expand(n_frames, -1))[:, :_PYIN_K]

    has_cand = cand_tau >= 0
    ct = torch.clamp(cand_tau, min=1)
    cv = torch.gather(cmnd, 1, ct)
    cv_prev = torch.cat([torch.ones_like(cv[:, :1]), cv[:, :-1]], dim=1)

    grid_n = beta_cdf.shape[0]

    def cdf(v):
        pos = torch.clamp(v, 0.0, 1.0) * (grid_n - 1)
        i0 = torch.floor(pos).long()
        i1 = torch.clamp(i0 + 1, max=grid_n - 1)
        w = pos - i0
        return beta_cdf[i0] * (1 - w) + beta_cdf[i1] * w

    mass = torch.where(has_cand, cdf(cv_prev) - cdf(cv), 0.0)
    k_idx = torch.arange(_PYIN_K, device=dev)
    deepest = torch.argmax(torch.where(has_cand, k_idx, -1), dim=1)
    deep_mass = cdf(torch.min(torch.where(has_cand, cv, math.inf), dim=1).values)
    extra = torch.where(has_cand.any(dim=1), no_trough_prob * deep_mass, 0.0)
    mass = mass + torch.where(k_idx == deepest[:, None], extra[:, None], 0.0)

    def at(t):
        return torch.gather(cmnd, 1, torch.clamp(t, 0, half))

    offset = _parabolic(at(ct - 1), cv, at(ct + 1))
    freqs = _rdiv(float(sampling_rate), torch.clamp(ct + offset, min=1e-6))
    valid = has_cand & (freqs >= f0_min) & (freqs <= f0_max)
    return torch.where(valid, freqs, 0.0), torch.where(valid, mass, 0.0)


def _pyin_transition(n_bins: int, switch_prob: float, window: int) -> np.ndarray:
    """[2S, 2S] log-transition matrix (host float64, returned float32):
    triangular local pitch moves within ``window`` bins times
    voiced <-> unvoiced switching."""
    S = n_bins
    local = np.zeros((S, S), np.float64)
    for i in range(S):
        lo, hi = max(0, i - window), min(S, i + window + 1)
        w = window + 1 - np.abs(np.arange(lo, hi) - i)
        local[i, lo:hi] = w / w.sum()
    A = np.block(
        [
            [(1 - switch_prob) * local, switch_prob * local],
            [switch_prob * local, (1 - switch_prob) * local],
        ]
    )
    return np.log(np.maximum(A, 1e-30)).astype(np.float32)


@PITCH_EXTRACTORS.register_module(name="PyinPitchExtractor")
class PyinPitchExtractor(_FramedExtractor):
    """Probabilistic YIN (= librosa.pyin): the candidates of
    ``_pyin_observations`` binned into ``bins_per_octave`` pitch bins from
    ``f0_min``, one voiced and one unvoiced state per bin, decoded by K8
    pYIN (``pyin_viterbi``); each voiced frame takes the candidate nearest
    its decoded bin (within one bin), else the bin's centre."""

    def __init__(self, frame_length: int = 2048, bins_per_octave: int = 48,
                 switch_prob: float = 0.01, transition_width: int = 8,
                 beta_parameters=(2.0, 18.0), device="cuda", **kwargs):
        super().__init__(frame_length, device, **kwargs)
        self.bins_per_octave = bins_per_octave
        self.switch_prob = switch_prob
        self.transition_width = transition_width
        self._beta_cdf = torch.from_numpy(_beta_cdf_grid(*beta_parameters)).to(self.device)
        self._n_bins = int(np.ceil(np.log2(self.f0_max / self.f0_min) * bins_per_octave))
        self._log_A = torch.from_numpy(
            _pyin_transition(self._n_bins, switch_prob, transition_width)).to(self.device)

    def f0(self, x, sampling_rate):
        freqs, probs = _pyin_observations(x, sampling_rate, *self._band(),
                                          beta_cdf=self._beta_cdf)
        return self._decode(freqs, probs)

    def observations(self, freqs, probs):
        """(bins [F, K] of the candidates, log_obs [F, 2S]): the voiced
        states carry the candidates' mass added into their bins, the
        unvoiced ones share 1 - the voiced mass."""
        S, bpo = self._n_bins, self.bins_per_octave
        T = freqs.shape[0]
        pos = torch.log2(torch.clamp(freqs, min=1e-6) / self.f0_min) * bpo
        bins = torch.where(freqs > 0, torch.clamp(pos.int(), 0, S - 1), 0).long()
        # the JAX package's scatter-add sums a bin's candidates in k order;
        # one scatter_add_ per k (unique indices in each row) keeps that
        # order on the card too, where duplicates would meet in atomics
        obs_v = torch.zeros((T, S), device=freqs.device)
        for k in range(freqs.shape[1]):
            obs_v.scatter_add_(1, bins[:, k : k + 1], probs[:, k : k + 1])
        p_voiced = torch.clamp(probs.sum(dim=1), 0.0, 1.0)
        obs_u = ((1.0 - p_voiced) / S)[:, None].expand(T, S)
        return bins, torch.log(torch.cat([obs_v, obs_u], dim=1) + 1e-12)

    def _decode(self, freqs, probs):
        S, bpo = self._n_bins, self.bins_per_octave
        _, log_obs = self.observations(freqs, probs)
        path = pyin_viterbi(log_obs[None].contiguous(), self._log_A)[0]
        voiced = path < S
        bin_idx = torch.where(voiced, path, 0)
        bin_f = self.f0_min * 2.0 ** ((bin_idx.float() + 0.5) / bpo)
        dist = torch.where(
            freqs > 0,
            torch.log2(torch.clamp(freqs, min=1e-6) / bin_f[:, None]).abs(),
            math.inf,
        )
        d_near, nearest = torch.min(dist, dim=1)
        cand_f = torch.gather(freqs, 1, nearest[:, None])[:, 0]
        use_cand = torch.isfinite(d_near) & (d_near < 1.0 / bpo)
        return torch.where(voiced, torch.where(use_cand, cand_f, bin_f), 0.0)
