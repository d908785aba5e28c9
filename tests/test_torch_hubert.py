"""PyTorch port vs the JAX package: HubertSoft content features with the
same weights (carried across by ``convert.hubert_soft_from_jax``).

The width stays 768 (the JAX soft-unit head's input is fixed at 768); the
tower is cut to 2 layers."""

import numpy as np
import pytest
import torch

from fish_diffusion_tpu.extractors.feature import HubertSoft as JHubertSoft
from fish_diffusion_tpu.extractors.feature import resample_linear as j_resample
from fish_diffusion_tpu_torch.convert import hubert_soft_from_jax
from fish_diffusion_tpu_torch.extractors.feature import HubertSoft, resample_linear


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def extractors():
    jax_ext = JHubertSoft(num_layers=2, random_init=True)
    port = HubertSoft(num_layers=2, device="cpu")
    port.load_state_dict(hubert_soft_from_jax(jax_ext.params))
    return jax_ext, port


def test_resample_linear_matches():
    audio = np.random.default_rng(0).standard_normal(44100).astype(np.float32)
    np.testing.assert_array_equal(resample_linear(audio, 44100, 16000),
                                  j_resample(audio, 44100, 16000))


def test_hubert_soft_matches_jax(extractors):
    """1 s of 44.1 kHz audio -> [1, 256, T] soft units: <= 1e-4 relative to
    the largest feature."""
    jax_ext, port = extractors
    t = np.arange(44100) / 44100
    rng = np.random.default_rng(1)
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(44100))
    audio = audio.astype(np.float32)
    ref = jax_ext(audio, 44100)
    got = port(audio, 44100)
    assert got.shape == ref.shape == (1, 256, 49)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, err


def test_hubert_soft_needs_weights():
    with pytest.raises(RuntimeError, match="no weights"):
        HubertSoft(num_layers=1, device="cpu")(np.zeros(16000, np.float32), 16000)
