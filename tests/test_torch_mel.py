"""PyTorch port vs the JAX package: the mel transform (``ops/mel.py``) and
``NsfHifiGAN.wav2spec``. On the CPU the port's STFT magnitude (K5) runs its
plain version."""

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
    got = tmel.stft_magnitude(y, tmel._dft_basis(n_fft, win, "cpu"), hop)
    window = torch.hann_window(win)
    pad = (n_fft - win) // 2
    window = torch.nn.functional.pad(window, (pad, n_fft - win - pad))
    ref = torch.stft(y, n_fft, hop, n_fft, window, center=False, return_complex=True).abs()
    assert got.shape == ref.shape == (2, n_fft // 2 + 1, (y.shape[1] - n_fft) // hop + 1)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
