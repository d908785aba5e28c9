"""PyTorch port vs the JAX package: the candidate Viterbi (K8-cand, plain
version on the CPU), ``HarvestPitchExtractor`` and
``BasePitchExtractor.post_process``.

Harvest makes discrete decisions (the +-10% channel bands, the channel
energy gate, non-max suppression, the Viterbi argmax), and float32 FFTs in
pocketfft and in XLA differ by ~1e-6 relative. The signals are those of
``tests/test_pitch_world.py`` (steady and vibrato tones, a high tone,
silent gaps) plus a two-partial tone, all clear of the gates' edges: every
frame's voicing must agree, and voiced f0 within 1 cent."""

import numpy as np
import pytest
import torch

from fish_diffusion_tpu.extractors.pitch import BasePitchExtractor as JBase
from fish_diffusion_tpu.extractors.pitch import _viterbi_candidates
from fish_diffusion_tpu.extractors.world import HarvestPitchExtractor as JHarvest
from fish_diffusion_tpu_torch.extractors.pitch import (
    BasePitchExtractor,
    viterbi_candidates,
    viterbi_candidates_reference,
)
from fish_diffusion_tpu_torch.extractors.world import HarvestPitchExtractor
from fish_diffusion_tpu_torch.registry import PITCH_EXTRACTORS

SR, HOP = 44100, 512


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(f0_frames, n_harm=6, noise=0.004, seed=0, partials=None):
    """``tests/test_pitch_world.py``'s harmonic tone (``partials``: explicit
    (harmonic, amplitude) pairs instead of 1/k)."""
    f0_up = np.repeat(f0_frames, HOP)
    phase = 2 * np.pi * np.cumsum(f0_up) / SR
    x = np.zeros_like(phase)
    for k, a in partials or [(k, 1 / k) for k in range(1, n_harm + 1)]:
        x += a * np.sin(k * phase)
    x *= 0.5 / (np.abs(x).max() + 1e-9)
    x *= (f0_up > 0).astype(np.float64)
    rng = np.random.default_rng(seed)
    return (x + noise * rng.standard_normal(len(x))).astype(np.float32)


def _vibrato(n=120, center=294.0):
    t = np.arange(n)
    return (center * 2 ** ((30 / 1200) * np.sin(2 * np.pi * 5 * t * HOP / SR))).astype(np.float32)


def _gaps():
    truth = np.full(120, 250.0, np.float32)
    truth[:25] = 0.0
    truth[60:80] = 0.0
    return truth


SIGNALS = {
    "steady_220": lambda: _tone(np.full(120, 220.0, np.float32)),
    "high_640": lambda: _tone(np.full(120, 640.0, np.float32)),
    "vibrato_294": lambda: _tone(_vibrato()),
    "silent_gaps": lambda: _tone(_gaps()),
    "two_partials_180": lambda: _tone(np.full(120, 180.0, np.float32),
                                      partials=[(1, 1.0), (2, 0.6)]),
}


def random_candidates(rng, B, T, K=4):
    freqs = rng.uniform(50, 1100, (B, T, K)).astype(np.float32)
    freqs[rng.random((B, T, K)) < 0.3] = 0.0
    strengths = rng.uniform(-1, 1, (B, T, K)).astype(np.float32)
    unvoiced = rng.uniform(0, 1.5, (B, T)).astype(np.float32)
    return freqs, strengths, unvoiced


@pytest.mark.parametrize("T", [1, 37, 400])
def test_viterbi_candidates_matches_jax(T):
    """Random candidate maps (30% empty), two items: f0 identical."""
    rng = np.random.default_rng(T)
    freqs, strengths, unvoiced = random_candidates(rng, 2, T)
    f0, path = viterbi_candidates(*(torch.from_numpy(a) for a in (freqs, strengths, unvoiced)))
    assert f0.shape == path.shape == (2, T) and path.dtype == torch.int32
    for b in range(2):
        ref = np.asarray(_viterbi_candidates(freqs[b], strengths[b], unvoiced[b]))
        np.testing.assert_array_equal(f0[b].numpy(), ref)


def test_viterbi_candidates_ties_take_the_first_state():
    """Equal candidates and strengths tie every score: the path keeps state
    0, as ``jnp.argmax`` does; the JAX decoder gives the same f0."""
    T = 20
    freqs = np.full((1, T, 4), 220.0, np.float32)
    strengths = np.full((1, T, 4), 0.5, np.float32)
    unvoiced = np.full((1, T), 0.5, np.float32)
    f0, path = viterbi_candidates_reference(
        *(torch.from_numpy(a) for a in (freqs, strengths, unvoiced)))
    assert (path == 0).all()
    ref = np.asarray(_viterbi_candidates(freqs[0], strengths[0], unvoiced[0]))
    np.testing.assert_array_equal(f0[0].numpy(), ref)


@pytest.mark.parametrize("name", list(SIGNALS))
def test_harvest_matches_jax(name):
    """Every frame's voicing identical; voiced f0 within 1 cent."""
    x = SIGNALS[name]()
    ref = np.asarray(JHarvest()(x, SR))
    got = HarvestPitchExtractor(device="cpu")(x, SR)
    assert got.shape == ref.shape == (len(x) // HOP + 1,)
    assert (ref > 0).sum() > 30
    np.testing.assert_array_equal(got > 0, ref > 0)
    voiced = ref > 0
    cents = np.abs(1200 * np.log2(got[voiced] / ref[voiced]))
    assert cents.max() <= 1.0, cents.max()


def test_harvest_post_process_to_mel_frames():
    """Through ``post_process`` to 100 frames with interpolation over the
    gaps (``keep_zeros=False``, the SVC config's setting): within 1 cent."""
    x = SIGNALS["silent_gaps"]()
    ref = np.asarray(JHarvest(keep_zeros=False)(x, SR, pad_to=100))
    got = HarvestPitchExtractor(keep_zeros=False, device="cpu")(x, SR, pad_to=100)
    assert got.shape == ref.shape == (100,) and (ref > 0).all()
    assert np.abs(1200 * np.log2(got / ref)).max() <= 1.0
    assert isinstance(PITCH_EXTRACTORS.build(dict(type="HarvestPitchExtractor"), device="cpu"),
                      HarvestPitchExtractor)


@pytest.mark.parametrize("keep_zeros", [True, False])
@pytest.mark.parametrize("pattern", ["mixed", "one_voiced", "silent"])
def test_post_process_exact(keep_zeros, pattern):
    """Stretch to the mel length and (unless ``keep_zeros``) interpolate
    over unvoiced frames: equal to the JAX package's."""
    rng = np.random.default_rng(4)
    f0 = rng.uniform(100, 400, 57).astype(np.float32)
    if pattern == "mixed":
        f0[rng.random(57) < 0.4] = 0.0
    elif pattern == "one_voiced":
        f0[:] = 0.0
        f0[20] = 180.0
    else:
        f0[:] = 0.0
    kw = dict(hop_length=HOP, keep_zeros=keep_zeros)
    for pad_to in (None, 57, 80):
        ref = JBase(**kw).post_process(None, SR, f0, pad_to)
        got = BasePitchExtractor(**kw).post_process(None, SR, f0, pad_to)
        np.testing.assert_array_equal(got, ref)
