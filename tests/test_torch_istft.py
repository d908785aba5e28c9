"""PyTorch port vs the JAX package: K5 istft (``ops/mel.py:istft``).

- ``istft`` (on the CPU its plain version, ``torch.fft.irfft`` and a fold)
  against the JAX ``istft`` at iSTFTNet's n_fft 16 with hop 4 and 8, at
  2048 / 512, at a window shorter than n_fft and without centring;
- the window-square envelope K5 istft divides by against the JAX package's
  scatter-add;
- a round trip through K5's forward basis: the STFT of a signal, inverted,
  gives the signal back.

Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.ops.mel import istft as jistft
from fish_diffusion_tpu_torch.ops import mel


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def spectrum(seed, B, n_fft, F, scale=1.0):
    rng = np.random.default_rng(seed)
    bins = n_fft // 2 + 1
    return [(rng.standard_normal((B, bins, F)) * scale).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("n_fft,hop,win,F,center", [
    (16, 8, None, 40, True), (16, 4, None, 40, True), (2048, 512, None, 6, True),
    (16, 8, 12, 30, True), (16, 8, None, 30, False), (15, 5, None, 20, True),
])
def test_istft_matches_jax(n_fft, hop, win, F, center):
    """<= 1e-5 of the output's scale: float32 inverse transforms by two
    FFT libraries, the window products and the same envelope."""
    re, im = spectrum(n_fft + hop + F, 2, n_fft, F)
    ref = np.asarray(jistft(jnp.asarray(re), jnp.asarray(im), n_fft, hop, win, center))
    got = mel.istft(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop, win, center)
    assert got.shape == ref.shape
    assert got.shape[1] == n_fft + hop * (F - 1) - (2 * (n_fft // 2) if center else 0)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


@pytest.mark.parametrize("n_fft,hop,win,F", [(16, 8, 16, 9), (2048, 512, 2048, 5),
                                             (16, 8, 12, 7), (300, 75, 240, 6)])
def test_envelope_matches_the_jax_scatter_add(n_fft, hop, win, F):
    """The envelope K5 istft divides by: the JAX package's float32
    scatter-add of the window's square, clamped at 1e-11, exactly."""
    w = np.asarray(mel._padded_window(n_fft, win), np.float32)
    idx = (np.arange(F)[:, None] * hop + np.arange(n_fft)[None, :]).reshape(-1)
    out_len = n_fft + hop * (F - 1)
    norm = jnp.zeros(out_len).at[idx].add(jnp.asarray(np.tile(w * w, F)))
    ref = np.asarray(jnp.maximum(norm, 1e-11))
    got = mel._istft_envelope(n_fft, hop, win, F, "cpu").numpy()
    np.testing.assert_array_equal(got, ref)


def test_istft_inverts_the_forward_basis():
    """The STFT of a signal through K5's forward basis (complex, centred,
    reflect-padded), inverted by ``istft``: the signal back within 1e-5 of
    its scale, at iSTFTNet's n_fft 16 / hop 8 and at 2048 / 512."""
    rng = np.random.default_rng(3)
    for n_fft, hop in ((16, 8), (2048, 512)):
        y = torch.from_numpy(rng.standard_normal((2, hop * 40)).astype(np.float32))
        pad = n_fft // 2
        yp = torch.nn.functional.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
        basis = mel._dft_basis(n_fft, n_fft, "cpu")
        spec = (yp.unfold(-1, n_fft, hop) @ basis).transpose(1, 2)
        bins = n_fft // 2 + 1
        back = mel.istft(spec[:, :bins].contiguous(), spec[:, bins:].contiguous(), n_fft, hop)
        assert back.shape == y.shape
        assert (back - y).abs().max().item() <= 1e-5 * y.abs().max().item()
