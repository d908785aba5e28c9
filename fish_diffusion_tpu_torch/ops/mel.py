"""Mel spectrogram and STFT magnitude (``fish_diffusion_tpu/ops/mel.py``).

The windowed-DFT basis and the mel filter bank are built on the host in
float64 and cast to float32, as in the JAX package. The STFT magnitude is
K5, the hand-written CUDA FFT of ``csrc/stft.cu`` (a power-of-two n_fft as
a Stockham FFT in shared memory, any other n_fft up to ``MAX_N_FFT`` by
Bluestein's chirp-z transform on the same core, two frames per complex
transform, each scaled to its own peak; tables from ``_fft_tables``; the
backward in float64; an FFT too long for shared memory as a four-step FFT
through device memory, ``_split``): ``stft_magnitude`` launches it for
a CUDA tensor and takes ``stft_magnitude_reference`` (frames by ``unfold``,
one float32 ``matmul`` with the DFT basis) for a CPU tensor. The mel
projection ``[n_mels, bins] @ spec`` stays ``torch.matmul`` in float32, as
it stood outside the TPU kernel.

Conventions kept from the JAX package:
- reflect padding of ``(win - hop) / 2`` samples each side, ``center=False``;
- magnitude ``sqrt(re^2 + im^2 + 1e-9)``;
- key shift: n_fft and the window scaled by ``2 ** (key_shift / 12)`` and
  rounded (2299 at +2, not a power of two), the spectrum cropped or padded
  back to ``n_fft // 2 + 1`` bins and rescaled by ``win / win_new``;
- librosa's slaney-scale, slaney-norm filter bank;
- log compression: natural log of ``clamp(x, 1e-5)``, times 0.434294 for
  log10 mels.

Training differentiates the magnitude (``_StftMagnitude``): the forward
saves the padded signal, and the backward is K5's second kernel,
``stft_backward``, the hand VJP of the JAX package (``ops/mel.py:184``),
which recomputes the spectrum by the same FFT, with
``stft_backward_reference`` beside it.
``linear_spectrogram`` is the JAX ``stft_magnitude`` with its ``center``
option (the STFT loss). ``LogMelSpectrogram.log_mel`` is the
differentiable log-mel; ``wav2spec``, which serving calls, stays under
``torch.inference_mode``.

``istft`` (iSTFTNet's last step) is K5 istft, ``csrc/istft.cu``, in
three plans by size (``istft_plan``): n_fft 16 and 32 by an inverse DFT of
each frame compiled for its size, other sizes on K5's FFT core (pairs of
frames in one complex inverse transform), past shared memory by its
four-step FFTs, all on the tables of ``_fft_tables``; the
overlap-add is a gather in frame order (no atomics), divided by the
window-square envelope that ``_istft_envelope`` builds once per shape (the
direct plan sums it in place, in the same order).
``istft_reference`` (``torch.fft.irfft`` and ``fold``) is the plain
version.
"""

from __future__ import annotations

import functools
from typing import Optional

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


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    """The Hann window of ``win_length`` centred in ``n_fft`` zeros, float32."""
    pad = (n_fft - win_length) // 2
    return np.pad(_hann_window(win_length), (pad, n_fft - win_length - pad))


@functools.lru_cache(maxsize=None)
def _dft_kernel(n_fft: int, win_length: int, dtype=np.float32) -> np.ndarray:
    """Windowed DFT basis [2 * bins, 1, n_fft] (the JAX package's layout):
    row k < bins is the cos part of bin k, row bins + k its -sin part, each
    times the centred, zero-padded Hann window; computed in float64, then
    rounded to ``dtype``."""
    bins = n_fft // 2 + 1
    window = np.zeros(n_fft, dtype=np.float64)
    pad = (n_fft - win_length) // 2
    window[pad : pad + win_length] = _hann_window(win_length).astype(np.float64)

    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(bins, dtype=np.float64)
    angle = 2 * np.pi * k[:, None] * n[None, :] / n_fft
    real = np.cos(angle) * window[None, :]
    imag = -np.sin(angle) * window[None, :]
    return np.concatenate([real, imag], axis=0)[:, None, :].astype(dtype)


@functools.lru_cache(maxsize=16)
def _dft_basis(n_fft: int, win_length: int, device: str,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The operand of K5's plain versions: ``_dft_kernel`` as a contiguous
    [n_fft, 2 * bins] tensor of ``dtype`` (float32, or float64 for the
    exact function) on ``device``. Made outside inference mode, so that a
    basis first built while serving can be used in a backward later."""
    k = _dft_kernel(n_fft, win_length,
                    np.float64 if dtype == torch.float64 else np.float32)[:, 0, :]
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(k.T)).to(device)


# ---------------------------------------------------------------------------
# K5: the STFT magnitude
# ---------------------------------------------------------------------------

# K5 takes every n_fft up to this, in float32 and float64: FFTs that do not
# fit in shared memory run as four-step FFTs of L = L1 x L2 <= 2048 x 2048
# points through device memory
MAX_N_FFT = 1 << 21


def _split(L: int) -> int:
    """L1 of the four-step FFT L = L1 x L2 (L1 the larger half of the bits)."""
    bits = L.bit_length() - 1
    return 1 << ((bits + 1) // 2)


def _fft_size(n_fft: int) -> int:
    """K5's FFT length: n_fft when it is a power of two, else the least
    power of two >= 2 n_fft - 1 (Bluestein's convolution)."""
    return n_fft if n_fft & (n_fft - 1) == 0 else 1 << (2 * n_fft - 2).bit_length()


@functools.lru_cache(maxsize=None)
def _fft_tables(n_fft: int, win_length: int):
    """K5's host tables, built in float64: the padded window [n_fft]
    (float32, the plain version's values), the twiddles exp(-2 pi i t / L)
    [L, 2], and, when n_fft is not a power of two, Bluestein's chirp
    exp(-i pi (n^2 mod 2 n_fft) / n_fft) [n_fft, 2] and the filter spectrum
    FFT_L(conj chirp, wrapped circularly) / L [L, 2] (None otherwise).
    Complex values as (re, im)."""
    L = _fft_size(n_fft)

    def pairs(z):
        return np.ascontiguousarray(np.stack([z.real, z.imag], -1))

    twiddle = pairs(np.exp(-2j * np.pi * np.arange(L) / L))
    window = _padded_window(n_fft, win_length)
    if L == n_fft:
        return window, twiddle, None, None
    n = np.arange(n_fft, dtype=np.int64)
    chirp = np.exp(-1j * np.pi * ((n * n) % (2 * n_fft)) / n_fft)
    b = np.zeros(L, np.complex128)
    b[:n_fft] = np.conj(chirp)
    b[L - n_fft + 1:] = np.conj(chirp[1:])[::-1]
    return window, twiddle, pairs(chirp), pairs(np.fft.fft(b) / L)


@functools.lru_cache(maxsize=32)
def _fft_plan(n_fft: int, win_length: int, device: str, double: bool = False):
    """``_fft_tables`` as tensors on ``device`` (None stays None): the
    window float32, the others float32 (the forward) or float64 (the
    backward, with ``double``). Made outside inference mode like
    ``_dft_basis``."""
    dtype = torch.float64 if double else torch.float32
    window, *rest = _fft_tables(n_fft, win_length)
    with torch.inference_mode(False):
        return (torch.from_numpy(window).to(device),
                *(None if t is None else torch.from_numpy(t).to(device, dtype) for t in rest))


def _check_stft(name: str, y: torch.Tensor, n_fft: int, hop: int, win_length: int):
    if y.dtype != torch.float32:
        raise TypeError(f"{name}: takes float32, got {y.dtype}")
    if y.ndim != 2:
        raise ValueError(f"{name}: y {tuple(y.shape)}: expected [B, T]")
    if not 1 <= n_fft <= MAX_N_FFT:
        raise ValueError(f"{name}: n_fft {n_fft}: the kernel takes 1 to {MAX_N_FFT}")
    if not 1 <= win_length <= n_fft or hop < 1 or y.shape[1] < n_fft:
        raise ValueError(f"{name}: {y.shape[1]} samples, n_fft {n_fft}, hop {hop}, "
                         f"win_length {win_length}")


def _pointers(plan):
    return [None if t is None else t.data_ptr() for t in plan]


def _stft_reference(y: torch.Tensor, n_fft: int, hop: int, win_length: int):
    """(magnitude [B, bins, F], spectrum [B, 2 * bins, F]: re rows, then
    im rows) by the windowed-DFT basis product of the JAX package, in y's
    dtype (float32; float64 gives the exact function)."""
    basis = _dft_basis(n_fft, win_length, str(y.device), y.dtype)
    bins = n_fft // 2 + 1
    spec = (y.unfold(-1, n_fft, hop) @ basis).transpose(1, 2)  # [B, 2 * bins, F]
    re, im = spec[:, :bins], spec[:, bins:]
    return torch.sqrt(re * re + im * im + 1e-9), spec


def stft_magnitude_reference(y: torch.Tensor, n_fft: int, hop: int,
                             win_length: Optional[int] = None) -> torch.Tensor:
    """Plain version of K5. y [B, T_pad] -> [B, n_fft // 2 + 1, F] with
    F = (T_pad - n_fft) // hop + 1 (frames by ``unfold``, one ``matmul``
    with ``_dft_basis`` in y's dtype)."""
    return _stft_reference(y, n_fft, hop, win_length or n_fft)[0]


def _stft_forward(y: torch.Tensor, n_fft: int, hop: int, win_length: int,
                  exact: bool = False) -> torch.Tensor:
    """K5's forward, [B, bins, F], in float64 when ``exact``. CPU tensors
    take the plain version (in float64 when ``exact``)."""
    if not y.is_cuda:
        if exact:
            return stft_magnitude_reference(y.double(), n_fft, hop, win_length).float()
        return stft_magnitude_reference(y, n_fft, hop, win_length)
    kernels.require_cuda("stft_magnitude", y)
    _check_stft("stft_magnitude", y, n_fft, hop, win_length)
    B, T_pad = y.shape
    n_frames = (T_pad - n_fft) // hop + 1
    out = torch.empty((B, n_fft // 2 + 1, n_frames), dtype=torch.float32, device=y.device)
    lib = kernels.load_library("stft")
    L = _fft_size(n_fft)
    plan = _pointers(_fft_plan(n_fft, win_length, str(y.device), exact))
    if lib.stft_fits_shared(n_fft, L, 16 if exact else 8):
        status = (lib.stft_magnitude_f64 if exact else lib.stft_magnitude)(
            y.data_ptr(), *plan, out.data_ptr(), B, T_pad, n_fft, L, hop, n_frames,
            kernels.stream())
    else:
        dtype = torch.float64 if exact else torch.float32
        pairs = B * ((n_frames + 1) // 2)
        work = torch.empty((pairs, L, 2), dtype=dtype, device=y.device)
        scales = torch.empty((pairs, 2), dtype=dtype, device=y.device)
        status = lib.stft_magnitude_split(
            y.data_ptr(), *plan, work.data_ptr(), scales.data_ptr(), out.data_ptr(), B, T_pad,
            n_fft, L, _split(L), hop, n_frames, int(exact), kernels.stream())
    kernels.check(status, "stft_magnitude")
    kernels.count_launch("stft_magnitude")
    return out


def stft_backward_reference(g: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int,
                            win_length: Optional[int] = None) -> torch.Tensor:
    """Plain version of K5's backward: the magnitude's gradient g
    [B, bins, F] and the forward's signal y [B, T_pad] -> the signal's
    gradient [B, T_pad] (the spectrum recomputed by ``_stft_reference``,
    its gradient g * spectrum / magnitude through the DFT basis, then the
    frames' overlap-add)."""
    win_length = win_length or n_fft
    mag, spec = _stft_reference(y, n_fft, hop, win_length)
    gs = g.repeat(1, 2, 1) * (spec / mag.repeat(1, 2, 1))  # [B, 2 * bins, F]
    frames = _dft_basis(n_fft, win_length, str(y.device), y.dtype) @ gs  # [B, n_fft, F]
    F_ = frames.shape[2]
    covered = (F_ - 1) * hop + n_fft
    out = torch.nn.functional.fold(frames, (1, covered), (1, n_fft), stride=(1, hop))
    return F.pad(out.reshape(g.shape[0], covered), (0, y.shape[1] - covered))


def stft_backward(g: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int,
                  win_length: Optional[int] = None) -> torch.Tensor:
    """K5's backward (``csrc/stft.cu``): the signal's gradient [B, T_pad]
    from the magnitude's gradient g [B, bins, F] and the forward's signal
    y, whose spectrum the kernel recomputes, in float64 (four-step FFTs
    through device memory where the FFT does not fit in shared memory).
    CPU tensors take ``stft_backward_reference``."""
    win_length = win_length or n_fft
    if not g.is_cuda:
        return stft_backward_reference(g, y, n_fft, hop, win_length)
    kernels.require_cuda("stft_backward", g, y)
    _check_stft("stft_backward", y, n_fft, hop, win_length)
    B, T_pad = y.shape
    n_frames = (T_pad - n_fft) // hop + 1
    if tuple(g.shape) != (B, n_fft // 2 + 1, n_frames):
        raise ValueError(f"stft_backward: g {tuple(g.shape)} for y {tuple(y.shape)}, "
                         f"n_fft {n_fft}, hop {hop}")
    frames = torch.empty((B, n_frames, n_fft), dtype=torch.float32, device=g.device)
    grad = torch.empty((B, T_pad), dtype=torch.float32, device=g.device)
    lib = kernels.load_library("stft")
    L = _fft_size(n_fft)
    plan = _pointers(_fft_plan(n_fft, win_length, str(y.device), double=True))
    if lib.stft_fits_shared(n_fft, L, 16):
        status = lib.stft_backward(g.data_ptr(), y.data_ptr(), *plan, frames.data_ptr(),
                                   grad.data_ptr(), B, T_pad, n_fft, L, hop, n_frames,
                                   kernels.stream())
    else:
        pairs = B * ((n_frames + 1) // 2)
        work, work2 = (torch.empty((pairs, L, 2), dtype=torch.float64, device=g.device)
                       for _ in range(2))
        scales, gscales = (torch.empty((pairs, 2), dtype=torch.float64, device=g.device)
                           for _ in range(2))
        status = lib.stft_backward_split(
            g.data_ptr(), y.data_ptr(), *plan, work.data_ptr(), work2.data_ptr(),
            scales.data_ptr(), gscales.data_ptr(), frames.data_ptr(), grad.data_ptr(), B,
            T_pad, n_fft, L, _split(L), hop, n_frames, kernels.stream())
    kernels.check(status, "stft_backward")
    kernels.count_launch("stft_backward")
    return grad


class _StftMagnitude(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, n_fft, hop, win_length, exact):
        ctx.save_for_backward(y)
        ctx.conf = (n_fft, hop, win_length)
        return _stft_forward(y, n_fft, hop, win_length, exact)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return stft_backward(g.contiguous(), y, *ctx.conf), None, None, None, None


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int,
                   win_length: Optional[int] = None, exact: bool = False) -> torch.Tensor:
    """K5: the STFT magnitude without centring, ``sqrt(re^2 + im^2 + 1e-9)``
    of the DFT of every frame of ``y`` [B, T_pad] times the Hann window of
    ``win_length`` (default n_fft) centred in n_fft -> [B, n_fft // 2 + 1,
    F]. ``exact`` computes it in float64 (training: a log-mel loss reads
    bins at 1e-6 of a frame's peak, where a float32 FFT is off by a few
    percent). Differentiable in ``y``, with ``stft_backward`` (float64) as
    its backward, which recomputes the spectrum from the saved signal. CPU
    tensors take the plain versions."""
    win_length = win_length or n_fft
    if torch.is_grad_enabled() and y.requires_grad:
        return _StftMagnitude.apply(y, n_fft, hop, win_length, exact)
    return _stft_forward(y, n_fft, hop, win_length, exact)


def linear_spectrogram(y: torch.Tensor, n_fft: int, hop_length: int,
                       win_length: Optional[int] = None, center: bool = False,
                       exact: bool = False):
    """The JAX package's ``stft_magnitude``: [B, T] -> [B, n_fft // 2 + 1,
    frames], reflect-padded by ``n_fft // 2`` on each side when ``center``;
    in float64 when ``exact`` (``stft_magnitude``)."""
    win_length = win_length or n_fft
    if center:
        pad = n_fft // 2
        y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    return stft_magnitude(y.contiguous(), n_fft, hop_length, win_length, exact=exact)


# ---------------------------------------------------------------------------
# K5 istft: the inverse STFT
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _istft_envelope(n_fft: int, hop: int, win_length: int, frames: int,
                    device: str) -> torch.Tensor:
    """max(sum_f w[t - f * hop]^2, 1e-11) over the n_fft + hop * (frames - 1)
    samples of an overlap-add, summed in float32 in frame order."""
    wsq = _padded_window(n_fft, win_length) ** 2
    k_ov = -(-n_fft // hop)
    blocks = np.pad(wsq, (0, k_ov * hop - n_fft)).reshape(k_ov, hop)
    acc = np.zeros((frames + k_ov - 1, hop), np.float32)
    for j in range(k_ov - 1, -1, -1):  # block m sums frames m - j, in frame order
        acc[j : j + frames] += blocks[j]
    env = np.maximum(acc.reshape(-1)[: n_fft + hop * (frames - 1)], np.float32(1e-11))
    with torch.inference_mode(False):
        return torch.from_numpy(env).to(device)


def istft_reference(real: torch.Tensor, imag: torch.Tensor, n_fft: int,
                    hop_length: int, win_length: Optional[int] = None,
                    center: bool = True) -> torch.Tensor:
    """Plain version of K5 istft, the JAX package's formula: ``irfft`` of
    every frame of the spectrum real + i imag [B, n_fft // 2 + 1, F], times
    the window, overlap-added at ``f * hop`` and divided by the window-square
    envelope (at least 1e-11); with ``center``, n_fft // 2 samples trimmed
    from each end -> [B, hop * (F - 1)] (centred)."""
    win_length = win_length or n_fft
    window = torch.from_numpy(_padded_window(n_fft, win_length)).to(real.device)
    # irfft reads neither the imaginary part of bin 0 nor, for an even
    # n_fft, the Nyquist bin's (numpy's and so the JAX package's drop them;
    # a C2R FFT on the card need not): zeroed, so that every device agrees
    imag = imag.float().clone()
    imag[:, 0] = 0.0
    if n_fft % 2 == 0:
        imag[:, n_fft // 2] = 0.0
    spec = torch.complex(real.float(), imag).transpose(1, 2)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window  # [B, F, n_fft]
    B, F_, _ = frames.shape
    out_len = n_fft + hop_length * (F_ - 1)

    def overlap_add(x):  # [N, F, n_fft] -> [N, out_len]
        return F.fold(x.transpose(1, 2), (1, out_len), (1, n_fft),
                      stride=(1, hop_length)).reshape(x.shape[0], out_len)

    audio = overlap_add(frames)
    norm = overlap_add((window * window).expand(1, F_, n_fft))
    audio = audio / torch.clamp(norm, min=1e-11)
    if center:
        audio = audio[:, n_fft // 2 : out_len - n_fft // 2]
    return audio


# K5 istft's plans (``csrc/istft.cu``), by ``istft_plan``'s numbers
ISTFT_PLANS = ("direct", "fft", "split")


@functools.lru_cache(maxsize=64)
def istft_plan(n_fft: int, hop_length: int, n_frames: int) -> str:
    """The plan K5 istft takes for a size: "direct" (n_fft 16, 32), "fft"
    (the shared-memory FFT core) or "split" (four-step FFTs through device
    memory). Raises for a size it does not take."""
    plan = kernels.load_library("istft").istft_plan(n_fft, hop_length, n_frames)
    if plan < 0:
        raise ValueError(f"istft: n_fft {n_fft}, hop {hop_length}, {n_frames} frames: "
                         "no plan takes this size")
    return ISTFT_PLANS[plan]


def _istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_length: int,
           win_length: int, center: bool) -> torch.Tensor:
    """K5 istft's launch on CUDA tensors, in the plan its rule picks.
    Uncounted."""
    kernels.require_cuda("istft", real, imag)
    if real.dtype != torch.float32:
        raise TypeError(f"istft: takes float32, got {real.dtype}")
    bins = n_fft // 2 + 1
    if real.ndim != 3 or real.shape != imag.shape or real.shape[1] != bins:
        raise ValueError(f"istft: real {tuple(real.shape)}, imag {tuple(imag.shape)}: "
                         f"expected [B, {bins}, frames] each")
    if hop_length < 1 or win_length > n_fft:
        raise ValueError(f"istft: hop {hop_length}, win_length {win_length}, "
                         f"n_fft {n_fft}")
    B, _, n_frames = real.shape
    device = str(real.device)
    offset = n_fft // 2 if center else 0
    n_out = n_fft + hop_length * (n_frames - 1) - 2 * offset
    if n_out <= 0:
        raise ValueError(f"istft: {n_frames} frames give no samples")
    which = istft_plan(n_fft, hop_length, n_frames)
    out = torch.empty((B, n_out), dtype=torch.float32, device=real.device)
    env = _istft_envelope(n_fft, hop_length, win_length, n_frames, device)
    work = scales = frames = None
    L1 = 0
    tables = _fft_plan(n_fft, win_length, device, double=which == "split")
    if which in ("fft", "split"):
        frames = torch.empty((B, n_frames, n_fft), dtype=torch.float32, device=real.device)
    if which == "split":
        L = _fft_size(n_fft)
        L1, pairs = _split(L), B * ((n_frames + 1) // 2)
        work = torch.empty((pairs, L, 2), dtype=torch.float64, device=real.device)
        scales = torch.empty((pairs, 2), dtype=torch.float64, device=real.device)
    status = kernels.load_library("istft").istft(
        real.data_ptr(), imag.data_ptr(), *_pointers(tables), env.data_ptr(),
        *_pointers([work, scales, frames]), out.data_ptr(), B, n_frames, n_fft, hop_length,
        L1, n_out, offset, kernels.stream())
    kernels.check(status, "istft")
    return out


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_length: int,
          win_length: Optional[int] = None, center: bool = True) -> torch.Tensor:
    """K5 istft (``csrc/istft.cu``): the inverse STFT of real + i imag
    [B, n_fft // 2 + 1, F] by windowed overlap-add, ``torch.istft``'s
    contract -> [B, hop * (F - 1)] when centred, else [B, n_fft + hop *
    (F - 1)]. The plan comes from the size (``istft_plan``); the
    window-square envelope is built once per shape. CPU tensors take
    ``istft_reference``. ``LAUNCHES["istft"]`` counts calls: the direct
    plan is one kernel, the FFT plan two (the transforms, the gather), the
    split path five (eight by Bluestein)."""
    win_length = win_length or n_fft
    if not real.is_cuda:
        return istft_reference(real, imag, n_fft, hop_length, win_length, center)
    out = _istft(real, imag, n_fft, hop_length, win_length, center)
    kernels.count_launch("istft")
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
    CPU). With ``exact`` (the training losses) the STFT runs in float64
    (``stft_magnitude``)."""

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
        exact: bool = False,
    ):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.f_min = f_min
        self.f_max = f_max
        self.n_mels = n_mels
        self.use_natural_log = use_natural_log
        self.exact = exact
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
        spec = stft_magnitude(y, n_fft_new, hop, win_new, exact=self.exact)

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

    def log_mel(self, y, key_shift: float = 0.0, speed: float = 1.0):
        """Audio [B, T] or [T] -> log-mel [B, n_mels, frames], differentiable
        in ``y`` (the training losses)."""
        return self.compress(self(y, key_shift=key_shift, speed=speed))

    @torch.inference_mode()
    def wav2spec(self, y, key_shift: float = 0.0, speed: float = 1.0):
        """Audio [B, T] or [T] -> log-mel [B, n_mels, frames] (serving)."""
        return self.log_mel(y, key_shift=key_shift, speed=speed)
