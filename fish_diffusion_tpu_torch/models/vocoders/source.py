"""NSF harmonic source from frame-rate f0 (``fish_diffusion_tpu/models/vocoders/source.py``).

The signal is that of the JAX package's ``BlockedSourceModule`` with
nearest f0 upsampling (the NSF-HiFiGAN case): per-sample f0 holds each
frame's value for ``hop`` samples; the phase is an exclusive sum of the
frames' phase advances, mod 1, plus the intra-frame advance
``(j + 1) * f0 / sr``; harmonic n has phase ``n * phase + rand_ini_n``
(rand_ini_0 = 0); the sines are gated by voicing, noise is added, and a
Dense(9 -> 1) with tanh merges them. The blocked ``[B, T, hop]`` layout was
a TPU device and is not carried over.

K3 is one CUDA kernel a pass, ``nsf_merge`` (``csrc/nsf_source.cu``),
replacing the JAX package's ``blocked_phase`` (``source.py:77``) and
``BlockedSineGen`` with the merge (``source.py:92-169``):

- the frame-phase scan runs inside the kernel's blocks: each block sums
  the frames' advances up to its own frames in float64, in one order fixed
  by the frame index (tiles of 256 frames, the tiles in order), so that
  every block, and the backward, forms the same bits; reduced mod 1 at the
  end, exact for any order in this mode, where the TPU's float32 mod-1
  scan rounds at every step (``nsf_phase_base_reference`` is its plain
  version);
- a block owns a run of samples of one row; its contiguous noise span
  comes into shared memory a chunk at a time by TMA bulk copies, and each
  sample takes one ``sincospif`` (the harmonics by rotation, the start
  phases by angle addition), the voicing gate, the noise and the merge;
  only the merged ``[B, T * hop]`` signal is written.

On an H100 it is bound by memory: it reads the ``[B, T * hop, 9]`` noise
(drawn outside, with a ``torch.Generator``; an in-kernel Philox draw is
later work) and writes ``[B, T * hop]``. ``nsf_merge_reference`` is the
plain version. Every merge takes a given ``base`` too (the tests hold the
fused scan against the reference's bases that way).

Training trains the merge's Dense(9 -> 1) (``l_linear``): its gradient is
``nsf_merge_backward`` (CUDA, ``csrc/nsf_source.cu``, on the merge's
staged-noise core), which recomputes the scan and the signals and adds
its blocks' sums in a fixed order (replacing what XLA derives for
``source.py:92`` on the TPU), with ``nsf_merge_backward_reference``
beside it. The gradient reaches the merged source through the noise
convs' input gradient (K4).

RefineGAN's comb-tooth template (K9) replaces the JAX package's
``BlockedCombTooth`` (``source.py:172``) on linear f0 interpolation
(``sample_f0_blocked``, ``source.py:55``, whose per-lane coefficients are
``frame_interp_coeffs``): sample j of frame k has
``f0 = f[k-1] a_prev[j] + f[k] a_cur[j] + f[k+1] a_next[j]`` (edge frames
repeated), and its phase is the frame's base plus the same combination of
the coefficients' inclusive prefix sums, over sr, formed in float64
(within a frame the phase reaches hop * f0 / sr, 128 at hop 256 near
sr / 2, where float32's step would be 8e-6). The frame-phase scan's
``interp="linear"`` mode gives the bases (a frame advances by the prefix
sums' last entries). ``comb_merge`` is the core's comb mode
(``csrc/nsf_source.cu``): the scan, then per sample the phase,
``x = phase - round(phase)`` (half to even), the sinc comb
``0.1 sinc(sr x / (f0 + 1e-3))``, the voicing gate and the injected
noise; only ``[B, T * hop]`` is written. It needs no gradient (the
template depends on f0 and noise alone). Bound by memory: f0 and noise
in, the template out. ``comb_merge_reference`` is the plain version,
``CombToothSource`` the module.

RefineGAN's sine template (K9 sine) replaces the JAX package's
``RefineSineGen`` (``refinegan.py:252``), whose phase is a mod-1
associative scan over samples (``nsf_hifigan.py:188 _mod1_phase_scan``)
of linearly resized f0. ``sine_merge`` is ``nsf_merge``'s kernel in its
linear mode (``csrc/nsf_source.cu``): the linear scan, then per sample
the interpolated f0, the float64 phase (as K9 comb), each harmonic's sine
with its start phase, 0 above sr // 2, the amplitude, the voicing gate,
the injected noise and the Dense(H -> 1) merge with tanh; only
``[B, T * hop, 1]`` is written. The sines are stop-gradient but the merge
is trained: in training the kernel also writes the merge's inputs, and
``_SineMerge``'s backward is the analytic tanh/merge gradient in torch.
``sine_merge_reference`` is the plain version, ``RefineSineSource`` the
module (key ``merge``).

Every wrapper takes ``base=None`` (the kernel's scan; on the CPU the plain
version forms it with ``nsf_phase_base_reference``) or a given ``[B, T]``
base.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ... import kernels

NSF_MAX_HARMONICS = 16  # csrc/nsf_source.cu's MAX_H
NSF_MAX_FRAMES = 1 << 20  # csrc/nsf_source.cu's MAX_T
_NSF_CHUNK = 512  # csrc/nsf_source.cu's CHUNK: a block owns whole chunks of samples


def _true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """IEEE division by a scalar (on CUDA, torch turns ``x / float`` into a
    multiplication by the reciprocal, which rounds differently)."""
    return x / torch.tensor(divisor, dtype=x.dtype, device=x.device)


@functools.lru_cache(maxsize=None)
def frame_interp_coeffs(hop: int):
    """The per-lane coefficients of linear f0 interpolation, align_corners
    False (``fish_diffusion_tpu/models/vocoders/source.py:40``): rows
    a_prev, a_cur, a_next, [3, hop] float32; and their inclusive prefix
    sums, [3, hop] float64 (the phase is formed in float64)."""
    j = np.arange(hop, dtype=np.float64)
    pos = (j + 0.5) / hop - 0.5
    w = np.where(pos < 0, pos + 1.0, pos)
    a = np.stack([np.where(pos < 0, 1.0 - w, 0.0), np.where(pos < 0, w, 1.0 - w),
                  np.where(pos < 0, 0.0, w)]).astype(np.float32)
    return a, np.cumsum(a.astype(np.float64), axis=1)


@functools.lru_cache(maxsize=16)
def _coeff_tensors(hop: int, device: str):
    """``frame_interp_coeffs`` on ``device``, made outside inference mode."""
    a, psum = frame_interp_coeffs(hop)
    with torch.inference_mode(False):
        return torch.from_numpy(a).to(device), torch.from_numpy(psum).to(device)


def _neighbours(f0):
    """f0 [B, T] -> (f0 of the previous frame, of the next), edges repeated."""
    return (torch.cat([f0[:, :1], f0[:, :-1]], dim=1),
            torch.cat([f0[:, 1:], f0[:, -1:]], dim=1))


def nsf_phase_base_reference(f0, sampling_rate: int, hop: int,
                             interp: str = "nearest"):
    """Plain version of the frame-phase scan: f0 [B, T] -> the phase at the
    start of each frame, [B, T] in [0, 1]. ``interp="nearest"`` holds a
    frame's f0 for its ``hop`` samples (NSF-HiFiGAN); ``"linear"``
    interpolates it (RefineGAN), so that a frame advances by
    ``(f[k-1] A_prev + f[k] A_cur + f[k+1] A_next) / sr`` with A the
    coefficients' sums."""
    if interp == "nearest":
        advance = _true_div(f0, sampling_rate) * hop
    elif interp == "linear":
        sums = frame_interp_coeffs(hop)[1][:, -1]
        f_prev, f_next = (f.double() for f in _neighbours(f0))
        advance = (f_prev * float(sums[0]) + f0.double() * float(sums[1])
                   + f_next * float(sums[2])) / sampling_rate
    else:
        raise NotImplementedError(f"interp {interp!r}")
    advance = torch.remainder(advance.double(), 1.0)
    return torch.remainder(torch.cumsum(advance, dim=1) - advance, 1.0).float()


def _source_signals_reference(f0, base, rand_ini, noise, sampling_rate: int,
                              hop: int, sine_amp: float, noise_std: float):
    """The H gated sines plus noise that the merge mixes, [B, T, hop, H]
    (base None: the nearest mode's scan)."""
    B, T = f0.shape
    H = rand_ini.shape[1]
    if base is None:
        base = nsf_phase_base_reference(f0, sampling_rate, hop)
    rad = _true_div(f0, sampling_rate)
    j = torch.arange(1, hop + 1, dtype=torch.float32, device=f0.device)
    phase = torch.remainder(base[..., None] + rad[..., None] * j, 1.0)

    harmonics = torch.arange(1, H + 1, dtype=torch.float32, device=f0.device)
    ph = phase[..., None] * harmonics + rand_ini[:, None, None, :]
    sines = torch.sin(2 * math.pi * torch.remainder(ph, 1.0)) * sine_amp

    uv = (f0 > 0).float()[:, :, None, None]
    noise_amp = uv * noise_std + (1 - uv) * sine_amp / 3
    return sines * uv + noise_amp * noise.view(B, T, hop, H)


def nsf_merge_reference(f0, base, rand_ini, noise, weight, bias,
                        sampling_rate: int, hop: int, sine_amp: float = 0.1,
                        noise_std: float = 0.003):
    """Plain version of K3's kernel. f0 [B, T]; base [B, T] or None (then
    ``nsf_phase_base_reference``'s); rand_ini [B, H] (column 0 is 0); noise
    [B, T * hop, H] standard normal; weight [H]; bias [1] -> merged source
    [B, T * hop, 1]."""
    B, T = f0.shape
    sines = _source_signals_reference(f0, base, rand_ini, noise, sampling_rate,
                                      hop, sine_amp, noise_std)
    merged = sines @ weight + bias
    return torch.tanh(merged).reshape(B, T * hop, 1)


def nsf_merge_backward_reference(g, out, f0, base, rand_ini, noise,
                                 sampling_rate: int, hop: int,
                                 sine_amp: float = 0.1,
                                 noise_std: float = 0.003):
    """Plain version of K3's backward: g, out [B, T * hop, 1] (the merged
    source's gradient and the source itself) -> (dW [H], db [1]) with
    ``gz = g * (1 - out^2)``, ``dW[n] = sum gz * s_n``, ``db = sum gz``
    (base as ``nsf_merge_reference``'s)."""
    B, T = f0.shape
    sines = _source_signals_reference(f0, base, rand_ini, noise, sampling_rate,
                                      hop, sine_amp, noise_std)
    gz = (g * (1 - out * out)).reshape(B, T, hop, 1)
    return (gz * sines).sum(dim=(0, 1, 2)), gz.sum().reshape(1)


def nsf_source_reference(f0, rand_ini, noise, weight, bias, sampling_rate: int,
                         hop: int, sine_amp: float = 0.1,
                         noise_std: float = 0.003):
    """Plain version of K3: frame f0 [B, T] -> merged source [B, T * hop, 1]."""
    base = nsf_phase_base_reference(f0, sampling_rate, hop)
    return nsf_merge_reference(f0, base, rand_ini, noise, weight, bias,
                               sampling_rate, hop, sine_amp, noise_std)


def _check_sizes(name: str, f0, base, hop: int, H: int) -> None:
    """The sizes ``csrc/nsf_source.cu``'s kernels take."""
    if f0.dtype != torch.float32 or f0.ndim != 2:
        raise TypeError(f"{name}: takes float32 f0 [B, T]")
    if base is not None and tuple(base.shape) != tuple(f0.shape):
        raise ValueError(f"{name}: base must be [B, T] as f0")
    if hop & (hop - 1):
        raise ValueError(f"{name}: hop {hop} is not a power of two")
    if not 1 <= H <= NSF_MAX_HARMONICS:
        raise ValueError(f"{name}: {H} harmonics; the kernel takes 1 to "
                         f"{NSF_MAX_HARMONICS}")
    if f0.shape[1] > NSF_MAX_FRAMES:
        raise ValueError(f"{name}: {f0.shape[1]} frames; the kernel takes at most "
                         f"{NSF_MAX_FRAMES}")


def _ptr(t) -> Optional[int]:
    """A tensor's device pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def _given(*tensors):
    """The tensors that are not None."""
    return [t for t in tensors if t is not None]


def _nsf_merge_forward(f0, base, rand_ini, noise, weight, bias,
                       sampling_rate: int, hop: int, sine_amp: float = 0.1,
                       noise_std: float = 0.003):
    if not f0.is_cuda:
        return nsf_merge_reference(f0, base, rand_ini, noise, weight, bias,
                                   sampling_rate, hop, sine_amp, noise_std)
    kernels.require_cuda("nsf_merge", *_given(f0, base), rand_ini, noise, weight, bias)
    B, T = f0.shape
    H = rand_ini.shape[1]
    _check_sizes("nsf_merge", f0, base, hop, H)
    if (tuple(rand_ini.shape) != (B, H) or tuple(noise.shape) != (B, T * hop, H)
            or tuple(weight.shape) != (H,) or bias.numel() != 1):
        raise ValueError("nsf_merge: shapes do not match f0 [B, T]")
    out = torch.empty((B, T * hop, 1), dtype=f0.dtype, device=f0.device)
    kernels.check(kernels.load_library("nsf_source").nsf_merge(
        f0.data_ptr(), _ptr(base), rand_ini.data_ptr(), noise.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), out.data_ptr(), B, T, hop, H,
        float(sampling_rate), float(sine_amp), float(noise_std), kernels.stream()),
        "nsf_merge")
    kernels.count_launch("nsf_merge")
    return out


def nsf_merge_backward(g, out, f0, base, rand_ini, noise, sampling_rate: int,
                       hop: int, sine_amp: float = 0.1,
                       noise_std: float = 0.003):
    """K3's backward (``csrc/nsf_source.cu``): (dW [H], db [1]) of the
    Dense(H -> 1) merge. On ``nsf_merge``'s core, each block recomputes its
    frames' bases (the scan, where base is None), its samples' phase,
    sines, voicing and noise as the merge forms them (the
    ``[B, T * hop, H]`` signals never reach device memory) and writes its
    H + 1 sums; a second kernel adds the blocks' sums in block order, so a
    second call gives the same bits. H at most 16, hop a power of two. CPU
    tensors take ``nsf_merge_backward_reference``."""
    if not f0.is_cuda:
        return nsf_merge_backward_reference(g, out, f0, base, rand_ini, noise,
                                            sampling_rate, hop, sine_amp,
                                            noise_std)
    kernels.require_cuda("nsf_merge_backward", g, out, *_given(f0, base), rand_ini, noise)
    B, T = f0.shape
    H = rand_ini.shape[1]
    _check_sizes("nsf_merge_backward", f0, base, hop, H)
    if tuple(g.shape) != (B, T * hop, 1) or tuple(out.shape) != (B, T * hop, 1):
        raise ValueError("nsf_merge_backward: g and out must be [B, T * hop, 1]")
    if tuple(rand_ini.shape) != (B, H) or tuple(noise.shape) != (B, T * hop, H):
        raise ValueError("nsf_merge_backward: shapes do not match f0 [B, T]")
    # a block's partial sums: at most one block a chunk of samples
    partials = torch.empty(((H + 1) * B * -(-T * hop // _NSF_CHUNK),), dtype=f0.dtype,
                           device=f0.device)
    sums = torch.empty((H + 1,), dtype=f0.dtype, device=f0.device)
    kernels.check(kernels.load_library("nsf_source").nsf_merge_backward(
        g.data_ptr(), out.data_ptr(), f0.data_ptr(), _ptr(base), rand_ini.data_ptr(),
        noise.data_ptr(), partials.data_ptr(), sums.data_ptr(), B, T, hop, H,
        float(sampling_rate), float(sine_amp), float(noise_std), kernels.stream()),
        "nsf_merge_backward")
    kernels.count_launch("nsf_merge_backward")
    return sums[:H], sums[H:]


class _NsfMerge(torch.autograd.Function):
    """K3's merge with the gradient of its Dense(H -> 1) weights: only
    ``weight`` and ``bias`` are trained (f0 is data, the draws are not
    differentiated), so the backward is ``nsf_merge_backward``. A base of
    None is kept as None: the backward's kernel forms the forward's bases
    again, bit for bit."""

    @staticmethod
    def forward(ctx, f0, base, rand_ini, noise, weight, bias, sampling_rate,
                hop, sine_amp, noise_std):
        out = _nsf_merge_forward(f0, base, rand_ini, noise, weight, bias,
                                 sampling_rate, hop, sine_amp, noise_std)
        ctx.save_for_backward(f0, base, rand_ini, noise, out)
        ctx.conf = (sampling_rate, hop, sine_amp, noise_std)
        return out

    @staticmethod
    def backward(ctx, g):
        f0, base, rand_ini, noise, out = ctx.saved_tensors
        dw, db = nsf_merge_backward(g.contiguous(), out, f0, base, rand_ini,
                                    noise, *ctx.conf)
        return None, None, None, None, dw, db, None, None, None, None


def nsf_merge(f0, base, rand_ini, noise, weight, bias, sampling_rate: int,
              hop: int, sine_amp: float = 0.1, noise_std: float = 0.003):
    """K3 (``csrc/nsf_source.cu``; H at most 16 harmonics, hop a power of
    two): the frame-phase scan (base None) or the given base [B, T], then
    the sines, gate, noise and merge; differentiable in ``weight`` and
    ``bias`` (``_NsfMerge``). CPU tensors take ``nsf_merge_reference``."""
    args = (f0, base, rand_ini, noise, weight, bias, sampling_rate, hop,
            sine_amp, noise_std)
    if torch.is_grad_enabled() and (weight.requires_grad or bias.requires_grad):
        return _NsfMerge.apply(*args)
    return _nsf_merge_forward(*args)


def nsf_source(f0, rand_ini, noise, weight, bias, sampling_rate: int, hop: int,
               sine_amp: float = 0.1, noise_std: float = 0.003):
    """K3: frame f0 [B, T] -> merged source [B, T * hop, 1], one launch (the
    scan inside ``nsf_merge``)."""
    return nsf_merge(f0, None, rand_ini, noise, weight, bias, sampling_rate,
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


# ---------------------------------------------------------------------------
# K9: the comb-tooth template
# ---------------------------------------------------------------------------


def comb_merge_reference(f0, base, noise, sampling_rate: int, hop: int,
                         wave_amp: float = 0.1, noise_std: float = 0.003):
    """Plain version of K9's kernel. f0 [B, T]; base [B, T] or None (then
    ``nsf_phase_base_reference``'s linear mode); noise [B, T * hop]
    standard normal -> template [B, T * hop]."""
    B, T = f0.shape
    if base is None:
        base = nsf_phase_base_reference(f0, sampling_rate, hop, "linear")
    coef, psum = _coeff_tensors(hop, str(f0.device))
    f_prev, f_next = _neighbours(f0)
    fp, fc, fn = f_prev[..., None], f0[..., None], f_next[..., None]
    f0s = fp * coef[0] + fc * coef[1] + fn * coef[2]
    intra = fp.double() * psum[0] + fc.double() * psum[1] + fn.double() * psum[2]
    phase = torch.remainder(base[..., None].double() + intra / sampling_rate, 1.0)
    x = (phase - torch.round(phase)).float()
    comb = torch.sinc(sampling_rate * x / (f0s + 1e-3)) * wave_amp
    voiced = f0s > 0
    noise_amp = torch.where(voiced, noise_std, wave_amp / 3)
    out = torch.where(voiced, comb, 0.0) + noise_amp * noise.view(B, T, hop)
    return out.reshape(B, T * hop)


def comb_merge(f0, base, noise, sampling_rate: int, hop: int,
               wave_amp: float = 0.1, noise_std: float = 0.003):
    """K9 (``csrc/nsf_source.cu``'s comb mode; hop a power of two): the
    linear frame-phase scan (base None) or the given base [B, T], then per
    sample the interpolated f0, the float64 phase, the sinc comb, the
    voicing gate and the noise; only the ``[B, T * hop]`` template reaches
    device memory. CPU tensors take ``comb_merge_reference``."""
    if not f0.is_cuda:
        return comb_merge_reference(f0, base, noise, sampling_rate, hop, wave_amp,
                                    noise_std)
    kernels.require_cuda("comb_merge", *_given(f0, base), noise)
    _check_sizes("comb_merge", f0, base, hop, 1)
    B, T = f0.shape
    if tuple(noise.shape) != (B, T * hop):
        raise ValueError("comb_merge: noise must be [B, T * hop]")
    out = torch.empty((B, T * hop), dtype=f0.dtype, device=f0.device)
    coef, psum = _coeff_tensors(hop, str(f0.device))
    kernels.check(kernels.load_library("nsf_source").comb_merge(
        f0.data_ptr(), _ptr(base), coef.data_ptr(), psum.data_ptr(), noise.data_ptr(),
        out.data_ptr(), B, T, hop, float(sampling_rate), float(wave_amp), float(noise_std),
        kernels.stream()), "comb_merge")
    kernels.count_launch("comb_merge")
    return out


def comb_tooth_reference(f0, noise, sampling_rate: int, hop: int,
                         wave_amp: float = 0.1, noise_std: float = 0.003):
    """Plain version of K9: frame f0 [B, T] -> template [B, T * hop]."""
    base = nsf_phase_base_reference(f0, sampling_rate, hop, "linear")
    return comb_merge_reference(f0, base, noise, sampling_rate, hop, wave_amp,
                                noise_std)


def comb_tooth(f0, noise, sampling_rate: int, hop: int, wave_amp: float = 0.1,
               noise_std: float = 0.003):
    """K9: ``comb_merge`` with its scan, one launch."""
    return comb_merge(f0, None, noise, sampling_rate, hop, wave_amp, noise_std)


class CombToothSource(nn.Module):
    """RefineGAN's sinc comb excitation from frame-rate f0 (``BlockedCombTooth``
    with linear f0 interpolation). f0 [B, T] and standard normal noise
    [B, T * hop] (drawn by the caller) -> [B, T * hop, 1]. No parameters."""

    def __init__(self, sampling_rate: int, hop: int, wave_amp: float = 0.1,
                 noise_std: float = 0.003):
        super().__init__()
        self.sampling_rate, self.hop = sampling_rate, hop
        self.wave_amp, self.noise_std = wave_amp, noise_std

    def forward(self, f0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        B, T = f0.shape
        out = comb_tooth(f0.float().contiguous(), noise.reshape(B, T * self.hop).contiguous(),
                         self.sampling_rate, self.hop, self.wave_amp, self.noise_std)
        return out[..., None]


# ---------------------------------------------------------------------------
# K9 sine: RefineGAN's sine template
# ---------------------------------------------------------------------------


def _sine_signals_reference(f0, base, rand_ini, noise, sampling_rate: int, hop: int,
                            sine_amp: float, noise_std: float):
    """The H gated sines plus noise that the merge mixes, [B, T, hop, H]
    (base None: the linear mode's scan)."""
    B, T = f0.shape
    H = rand_ini.shape[1]
    if base is None:
        base = nsf_phase_base_reference(f0, sampling_rate, hop, "linear")
    coef, psum = _coeff_tensors(hop, str(f0.device))
    f_prev, f_next = _neighbours(f0)
    fp, fc, fn = f_prev[..., None], f0[..., None], f_next[..., None]
    f0s = fp * coef[0] + fc * coef[1] + fn * coef[2]
    intra = fp.double() * psum[0] + fc.double() * psum[1] + fn.double() * psum[2]
    phase = base[..., None].double() + intra / sampling_rate
    harmonics = torch.arange(1, H + 1, dtype=torch.float64, device=f0.device)
    ph = torch.remainder(phase[..., None] * harmonics + rand_ini[:, None, None, :].double(),
                         1.0).float()
    sines = torch.sin(2 * math.pi * ph)
    f0_h = f0s[..., None] * harmonics.float()
    sines = torch.where(f0_h > sampling_rate // 2, 0.0, sines) * sine_amp
    voiced = (f0s > 0)[..., None]
    noise_amp = torch.where(voiced, noise_std, sine_amp / 3)
    return torch.where(voiced, sines, 0.0) + noise_amp * noise.view(B, T, hop, H)


def sine_merge_reference(f0, base, rand_ini, noise, weight, bias, sampling_rate: int,
                         hop: int, sine_amp: float = 0.1, noise_std: float = 0.003):
    """Plain version of K9 sine. f0 [B, T]; base [B, T] or None (then
    ``nsf_phase_base_reference``'s linear mode); rand_ini [B, H] (column 0
    is 0); noise [B, T * hop, H] standard normal; weight [H]; bias [1] ->
    template [B, T * hop, 1]."""
    return _sine_merge_plain(f0, base, rand_ini, noise, weight, bias, sampling_rate, hop,
                             sine_amp, noise_std)[0]


def _sine_merge_plain(f0, base, rand_ini, noise, weight, bias, sampling_rate: int,
                      hop: int, sine_amp: float, noise_std: float):
    """-> (template [B, T * hop, 1], the merge's inputs [B, T * hop, H])."""
    B, T = f0.shape
    signals = _sine_signals_reference(f0, base, rand_ini, noise, sampling_rate, hop,
                                      sine_amp, noise_std).reshape(B, T * hop, -1)
    return torch.tanh(signals @ weight + bias)[..., None], signals


def _sine_merge_forward(f0, base, rand_ini, noise, weight, bias, sampling_rate: int,
                        hop: int, sine_amp: float, noise_std: float,
                        with_signals: bool = False):
    """-> (template [B, T * hop, 1], the merge's inputs [B, T * hop, H] or
    None). CPU tensors take the plain version."""
    if not f0.is_cuda:
        out, signals = _sine_merge_plain(f0, base, rand_ini, noise, weight, bias,
                                         sampling_rate, hop, sine_amp, noise_std)
        return out, (signals if with_signals else None)
    B, T = f0.shape
    H = rand_ini.shape[1]
    kernels.require_cuda("sine_merge", *_given(f0, base), rand_ini, noise, weight, bias)
    _check_sizes("sine_merge", f0, base, hop, H)
    if (tuple(rand_ini.shape) != (B, H) or tuple(noise.shape) != (B, T * hop, H)
            or tuple(weight.shape) != (H,) or bias.numel() != 1):
        raise ValueError("sine_merge: shapes do not match f0 [B, T]")
    out = torch.empty((B, T * hop, 1), dtype=f0.dtype, device=f0.device)
    signals = torch.empty_like(noise) if with_signals else None
    coef, psum = _coeff_tensors(hop, str(f0.device))
    kernels.check(kernels.load_library("nsf_source").sine_merge(
        f0.data_ptr(), _ptr(base), coef.data_ptr(), psum.data_ptr(),
        rand_ini.data_ptr(), noise.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        out.data_ptr(), _ptr(signals), B, T, hop, H,
        float(sampling_rate), float(sine_amp), float(noise_std),
        float(sampling_rate // 2), kernels.stream()), "sine_merge")
    kernels.count_launch("sine_merge")
    return out, signals


class _SineMerge(torch.autograd.Function):
    """K9 sine with the gradient of its Dense(H -> 1) merge. The template
    is stop-gradient (f0 is data, the draws are not differentiated), so
    only ``weight`` and ``bias`` take gradients. The forward has the kernel
    also write the merge's inputs s [B, T * hop, H]; the backward is the
    analytic one in torch: gz = g (1 - out^2), dW = sum gz s, db = sum gz."""

    @staticmethod
    def forward(ctx, f0, base, rand_ini, noise, weight, bias, sampling_rate, hop,
                sine_amp, noise_std):
        out, signals = _sine_merge_forward(f0, base, rand_ini, noise, weight, bias,
                                           sampling_rate, hop, sine_amp, noise_std,
                                           with_signals=True)
        ctx.save_for_backward(out, signals)
        return out

    @staticmethod
    def backward(ctx, g):
        out, signals = ctx.saved_tensors
        gz = g * (1 - out * out)  # [B, T * hop, 1]
        dw = (gz * signals).sum(dim=(0, 1))
        return None, None, None, None, dw, gz.sum().reshape(1), None, None, None, None


def sine_merge(f0, base, rand_ini, noise, weight, bias, sampling_rate: int, hop: int,
               sine_amp: float = 0.1, noise_std: float = 0.003):
    """K9 sine (``csrc/nsf_source.cu``, ``nsf_merge``'s core in its linear
    mode; H at most 16, hop a power of two): the linear frame-phase scan
    (base None) or the given base [B, T], then per sample the linearly
    interpolated f0, its float64 phase (the frame's base plus the
    intra-frame prefix sum of f0 / sr), the harmonics' sines with their
    start phases, the zero above sr // 2, the amplitude, the voicing gate,
    the noise and the Dense(H -> 1) merge with tanh; only the
    ``[B, T * hop, 1]`` template is written; differentiable in ``weight``
    and ``bias`` (``_SineMerge``). CPU tensors take
    ``sine_merge_reference``."""
    args = (f0, base, rand_ini, noise, weight, bias, sampling_rate, hop, sine_amp,
            noise_std)
    if torch.is_grad_enabled() and (weight.requires_grad or bias.requires_grad):
        return _SineMerge.apply(*args)
    return _sine_merge_forward(*args)[0]


def sine_template_reference(f0, rand_ini, noise, weight, bias, sampling_rate: int,
                            hop: int, sine_amp: float = 0.1, noise_std: float = 0.003):
    """Plain version of K9 sine with its phase scan: frame f0 [B, T] ->
    template [B, T * hop, 1]."""
    base = nsf_phase_base_reference(f0, sampling_rate, hop, "linear")
    return sine_merge_reference(f0, base, rand_ini, noise, weight, bias, sampling_rate,
                                hop, sine_amp, noise_std)


def sine_template(f0, rand_ini, noise, weight, bias, sampling_rate: int, hop: int,
                  sine_amp: float = 0.1, noise_std: float = 0.003):
    """K9 sine: ``sine_merge`` with its scan, one launch."""
    return sine_merge(f0, None, rand_ini, noise, weight, bias, sampling_rate, hop,
                      sine_amp, noise_std)


class RefineSineSource(nn.Module):
    """RefineGAN's sine template (``RefineSineGen`` on linearly interpolated
    f0): H = harmonic_num + 1 sines (1 as RefineGAN builds it) merged by a
    Dense(H -> 1) (key ``merge``) and tanh. f0 [B, T] and standard normal
    noise [B, T * hop, H] (drawn by the caller) -> [B, T * hop, 1]. The
    start phases rand_ini [B, H] (column 0 is 0) are given by the caller
    when H > 1; with one harmonic they are 0."""

    def __init__(self, sampling_rate: int, hop: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, noise_std: float = 0.003):
        super().__init__()
        self.sampling_rate, self.hop = sampling_rate, hop
        self.dim = harmonic_num + 1
        self.sine_amp, self.noise_std = sine_amp, noise_std
        self.merge = nn.Linear(self.dim, 1)

    def forward(self, f0: torch.Tensor, noise: torch.Tensor,
                rand_ini: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T = f0.shape
        if rand_ini is None:
            if self.dim > 1:
                raise ValueError("RefineSineSource: give rand_ini [B, H] for H > 1")
            rand_ini = torch.zeros((B, 1), device=f0.device)
        return sine_template(
            f0.float().contiguous(), rand_ini, noise.reshape(B, T * self.hop, self.dim),
            self.merge.weight[0], self.merge.bias, self.sampling_rate, self.hop,
            self.sine_amp, self.noise_std)
