"""PyTorch port vs the JAX package: praat-style autocorrelation pitch
(``_acf_candidates``, ``AutocorrPitchExtractor`` with and without the
candidate Viterbi, and its config name ``ParselMouthPitchExtractor``) and
YIN, on the tones of ``tests/test_torch_pitch.py``: candidates within 1e-5,
every frame's voicing identical, voiced f0 within 1 cent."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.extractors import pitch as jpitch
from fish_diffusion_tpu_torch.extractors import pitch
from fish_diffusion_tpu_torch.registry import PITCH_EXTRACTORS
from tests.test_torch_pitch import HOP, SIGNALS, SR


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_f0(got, ref, n_frames, min_voiced=30):
    assert got.shape == ref.shape == (n_frames,)
    assert (ref > 0).sum() > min_voiced
    np.testing.assert_array_equal(got > 0, ref > 0)
    voiced = ref > 0
    assert np.abs(1200 * np.log2(got[voiced] / ref[voiced])).max() <= 1.0


@pytest.mark.parametrize("name", list(SIGNALS))
def test_acf_candidates_match_jax(name):
    """Praat's candidates: the same peaks in the same order (a stable
    descending sort stands for ``lax.top_k``), frequencies within 1e-5
    relative, strengths and the unvoiced strength within 1e-5."""
    x = SIGNALS[name]()
    args = (SR, 2048, HOP, 50.0, 1100.0, 0.45)
    ref = [np.asarray(a) for a in jpitch._acf_candidates(jnp.asarray(x), *args)]
    got = [a.numpy() for a in pitch._acf_candidates(torch.from_numpy(x), *args)]
    assert got[0].shape == ref[0].shape == (len(x) // HOP + 1, 4)
    np.testing.assert_array_equal(got[0] > 0, ref[0] > 0)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-5)


def test_acf_candidates_tie_order():
    """Frames with fewer than four peaks (silence, a pure tone) fill the
    rest with -inf scores that all tie: the empty candidates come out in
    the same places as ``lax.top_k`` puts them. (230 Hz: its fourth
    subharmonic lies clear of the 50 Hz gate, where float32 rounding
    decides.)"""
    rng = np.random.default_rng(2)
    x = np.zeros(40 * HOP, np.float32)
    x[10 * HOP:30 * HOP] = 0.5 * np.sin(2 * np.pi * 230 * np.arange(20 * HOP) / SR)
    x += 1e-3 * rng.standard_normal(len(x)).astype(np.float32)
    args = (SR, 2048, HOP, 50.0, 1100.0, 0.45)
    ref = [np.asarray(a) for a in jpitch._acf_candidates(jnp.asarray(x), *args)]
    got = [a.numpy() for a in pitch._acf_candidates(torch.from_numpy(x), *args)]
    assert (ref[0] == 0).any() and (ref[0] > 0).any()
    np.testing.assert_array_equal(got[0] > 0, ref[0] > 0)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(SIGNALS))
@pytest.mark.parametrize("cls", ["ParselMouthPitchExtractor", "AutocorrPitchExtractor"])
def test_autocorr_matches_jax(name, cls):
    """The candidate Viterbi path (K8-cand's plain version on the CPU)."""
    x = SIGNALS[name]()
    ref = np.asarray(getattr(jpitch, cls)()(x, SR))
    ext = PITCH_EXTRACTORS.build(dict(type=cls), device="cpu")
    assert isinstance(ext, pitch.AutocorrPitchExtractor)
    assert_same_f0(ext(x, SR), ref, len(x) // HOP + 1)


@pytest.mark.parametrize("name", list(SIGNALS))
def test_autocorr_without_viterbi_matches_jax(name):
    """``use_viterbi=False``: each frame's best lag."""
    x = SIGNALS[name]()
    ref = np.asarray(jpitch.AutocorrPitchExtractor(use_viterbi=False)(x, SR))
    got = pitch.AutocorrPitchExtractor(use_viterbi=False, device="cpu")(x, SR)
    assert_same_f0(got, ref, len(x) // HOP + 1)


@pytest.mark.parametrize("name", list(SIGNALS))
def test_yin_matches_jax(name):
    x = SIGNALS[name]()
    ref = np.asarray(jpitch.YinPitchExtractor()(x, SR))
    got = PITCH_EXTRACTORS.build(dict(type="YinPitchExtractor"), device="cpu")(x, SR)
    assert_same_f0(got, ref, len(x) // HOP + 1)


@pytest.mark.parametrize("cls", ["ParselMouthPitchExtractor", "YinPitchExtractor"])
def test_post_process_to_mel_frames(cls):
    """Through ``post_process`` to 100 frames, interpolating over the gaps
    (``keep_zeros=False``, the configs' setting): within 1 cent."""
    x = SIGNALS["silent_gaps"]()
    ref = np.asarray(getattr(jpitch, cls)(keep_zeros=False)(x, SR, pad_to=100))
    got = PITCH_EXTRACTORS.build(dict(type=cls, keep_zeros=False), device="cpu")(
        x, SR, pad_to=100)
    assert got.shape == ref.shape == (100,) and (ref > 0).all()
    assert np.abs(1200 * np.log2(got / ref)).max() <= 1.0
