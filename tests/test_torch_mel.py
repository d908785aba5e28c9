"""PyTorch port vs the JAX package: the mel transform (``ops/mel.py``),
``NsfHifiGAN.wav2spec`` and the STFT magnitude's backward (the losses of
vocoder training). On the CPU the port's STFT magnitude (K5) and its
backward run their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.models.vocoders.nsf_hifigan import NsfHifiGAN as JNsfHifiGAN
from fish_diffusion_tpu.ops import mel as jmel
from fish_diffusion_tpu_torch.models.vocoders.nsf_hifigan import NsfHifiGAN
from fish_diffusion_tpu_torch.ops import mel as tmel

SR = 44100


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def audio(seconds=2.0, batch=1, seed=0):
    """A tone with vibrato and two partials over a white-noise floor loud
    enough that every STFT bin stays above the 1e-5 clamp."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    out = []
    for b in range(batch):
        f0 = 220.0 * (1 + b * 0.25) * (1 + 0.01 * np.sin(2 * np.pi * 5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / SR
        x = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.01 * rng.standard_normal(n)
        out.append(x)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("n_fft,win", [(2048, 2048), (2299, 2299), (1825, 1825), (64, 48)])
def test_host_tables_exact(n_fft, win):
    """The windowed-DFT basis and the filter bank equal the JAX package's."""
    np.testing.assert_array_equal(tmel._dft_kernel(n_fft, win), jmel._dft_kernel(n_fft, win))
    np.testing.assert_array_equal(tmel.mel_filter_bank(SR, 2048, 128, 40.0, 16000.0),
                                  jmel.mel_filter_bank(SR, 2048, 128, 40.0, 16000.0))


@pytest.mark.parametrize("key_shift", [0, 2, -2])
def test_log_mel_matches_jax(key_shift):
    """2 s, log10 mel (the configs' convention), key shift 0 and +-2
    (n_fft 2048, 2299, 1825): <= 1e-3 max abs."""
    y = audio(batch=2)
    kw = dict(sample_rate=SR, use_natural_log=False)
    ref = np.asarray(jmel.LogMelSpectrogram(**kw).wav2spec(jnp.asarray(y), key_shift=key_shift))
    got = tmel.LogMelSpectrogram(**kw, device="cpu").wav2spec(
        torch.from_numpy(y), key_shift=key_shift).numpy()
    assert got.shape == ref.shape == (2, 128, y.shape[1] // 512)
    assert ref.min() > -4.9  # every bin above the clamp (log10 1e-5 = -5)
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_vocoder_wav2spec_matches_jax():
    """``NsfHifiGAN.wav2spec``: channels-last [B, T // hop, M], <= 1e-3."""
    y = audio(seconds=1.5, seed=1)
    ref = np.asarray(JNsfHifiGAN(use_natural_log=False).wav2spec(jnp.asarray(y)))
    voc = NsfHifiGAN(use_natural_log=False, generator_config=dict(
        upsample_initial_channel=32, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3, 5),)), device="cpu")
    got = voc.wav2spec(torch.from_numpy(y)).numpy()
    assert got.shape == ref.shape == (1, y.shape[1] // 512, 128)
    np.testing.assert_allclose(got, ref, atol=1e-3)


@pytest.mark.parametrize("n_fft,win,hop", [(2048, 2048, 512), (2299, 2299, 512), (300, 240, 75)])
def test_stft_magnitude_matches_torch_stft(n_fft, win, hop):
    """The plain K5 against ``torch.stft(center=False, hann)``, the yardstick
    the card times beside the kernel: <= 1e-4 of the largest magnitude."""
    y = torch.from_numpy(audio(seconds=0.5, batch=2, seed=2))
    got = tmel.stft_magnitude(y, n_fft, hop, win)
    window = torch.hann_window(win)
    pad = (n_fft - win) // 2
    window = torch.nn.functional.pad(window, (pad, n_fft - win - pad))
    ref = torch.stft(y, n_fft, hop, n_fft, window, center=False, return_complex=True).abs()
    assert got.shape == ref.shape == (2, n_fft // 2 + 1, (y.shape[1] - n_fft) // hop + 1)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("n_fft,win", [(2048, 2048), (2299, 2299), (1933, 1500)])
def test_fft_tables_compose_the_dft(n_fft, win):
    """K5's host tables (``_fft_tables``), composed in numpy as the kernel
    composes them (float64 arithmetic on the tables rounded to float32, as
    the forward takes them): two windowed frames as one complex transform,
    Bluestein's chirp and filter spectrum when n_fft is not a power of two
    (2299 = 11 * 11 * 19; 1933 prime), and the pair split by conjugate
    symmetry, equal ``np.fft.rfft`` of each windowed frame in float64 within
    1e-6 of the largest magnitude (the float32 rounding)."""
    window, twiddle, chirp, filt = (None if t is None else t.astype(np.float32).astype(np.float64)
                                    for t in tmel._fft_tables(n_fft, win))
    L = tmel._fft_size(n_fft)
    assert twiddle.shape == (L, 2) and (chirp is None) == (L == n_fft)
    tw = twiddle[:, 0] + 1j * twiddle[:, 1]
    # the twiddles are those of L: an FFT by them is numpy's FFT
    np.testing.assert_allclose(tw, np.exp(-2j * np.pi * np.arange(L) / L), atol=1e-7)
    rng = np.random.default_rng(n_fft)
    x0, x1 = rng.standard_normal((2, n_fft))
    z = window * (x0 + 1j * x1)
    if chirp is None:
        Z = np.fft.fft(z)
    else:
        c = chirp[:, 0] + 1j * chirp[:, 1]
        h = filt[:, 0] + 1j * filt[:, 1]
        a = np.zeros(L, np.complex128)
        a[:n_fft] = z * c
        conv = np.conj(np.fft.fft(np.conj(np.fft.fft(a) * h)))  # the inverse as the kernel runs it
        Z = c * conv[:n_fft]
    bins = n_fft // 2 + 1
    k = np.arange(bins)
    zk, zm = Z[k], Z[(n_fft - k) % n_fft]
    X0, X1 = (zk + np.conj(zm)) / 2, (zk - np.conj(zm)) / 2j
    for got, x in ((X0, x0), (X1, x1)):
        ref = np.fft.rfft(window * x)
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("n_fft,hop,win", [(512, 128, 512), (2048, 270, 1080), (4096, 540, 2160)])
def test_stft_magnitude_and_vjp_match_jax(n_fft, hop, win, center):
    """The JAX ``stft_magnitude`` (``center`` both ways) and its hand VJP
    against the port's ``linear_spectrogram`` and its backward (K5's plain
    versions on the CPU): each <= 1e-4 of its largest value. The scales
    are those of the STFT and mel losses (hop 270 and 540 do not divide
    n_fft)."""
    y = audio(seconds=0.25, batch=2, seed=n_fft)
    ref, vjp = jax.vjp(lambda v: jmel.stft_magnitude(v, n_fft, hop, win, center=center),
                       jnp.asarray(y))
    ct = np.random.default_rng(hop).standard_normal(ref.shape).astype(np.float32)
    (ref_dy,) = vjp(jnp.asarray(ct))

    ty = torch.from_numpy(y).requires_grad_()
    got = tmel.linear_spectrogram(ty, n_fft, hop, win, center=center)
    (got * torch.from_numpy(ct)).sum().backward()
    ref, ref_dy = np.asarray(ref), np.asarray(ref_dy)
    assert got.shape == ref.shape
    assert np.abs(got.detach().numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.abs(ty.grad.numpy() - ref_dy).max() <= 1e-4 * np.abs(ref_dy).max()


def test_log_mel_is_differentiable_and_wav2spec_is_not():
    """``log_mel`` carries a gradient back to the signal (the mel loss);
    ``wav2spec`` (serving) runs under ``inference_mode``."""
    mt = tmel.LogMelSpectrogram(sample_rate=SR, device="cpu")
    y = torch.from_numpy(audio(seconds=0.3)).requires_grad_()
    mt.log_mel(y).sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all() and y.grad.abs().max() > 0
    assert mt.wav2spec(y.detach()).is_inference()
