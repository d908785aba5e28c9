"""PyTorch port vs the JAX package: DIO and StoneMask
(``DioPitchExtractor``) on the tones of ``tests/test_torch_pitch.py``: the
filter design identical, the channel candidates close (see their test),
every frame's voicing identical and voiced f0 within 1 cent, with and
without StoneMask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.extractors import world as jworld
from fish_diffusion_tpu_torch.extractors import world
from fish_diffusion_tpu_torch.registry import PITCH_EXTRACTORS
from tests.test_torch_pitch import HOP, SIGNALS, SR


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lowpass_design_equals_jax():
    for cutoff in (70.7, 400.0, 1131.4):
        np.testing.assert_array_equal(world._nuttall_lowpass(cutoff, 11025),
                                      jworld._nuttall_lowpass(cutoff, 11025))


@pytest.mark.parametrize("name", list(SIGNALS))
def test_dio_candidates_match_jax(name):
    """Each channel's candidate and spread in the frames DIO does not gate
    as silent: the same channels hold one, the stable ones (spread under
    0.12, those DIO may pick) within 2e-4 relative, every spread within
    1e-3, the frame RMS within 1e-5 relative. The candidates are event
    intervals of a low-passed float32 signal: its FFTs round differently in
    pocketfft and XLA (~1e-7), which moves a zero crossing's interpolated
    time by up to ~1e-4 of a period."""
    x = SIGNALS[name]()
    ref = [np.asarray(a) for a in jworld._dio_candidates(jnp.asarray(x), SR, HOP, 50.0, 1100.0)]
    got = [a.numpy() for a in world._dio_candidates(torch.from_numpy(x), SR, HOP, 50.0, 1100.0)]
    assert got[0].shape == ref[0].shape == (9, len(x) // HOP + 1)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-7)
    loud = ref[2] > 0.005
    c_ref, c_got = ref[0][:, loud], got[0][:, loud]
    np.testing.assert_array_equal(c_got > 0, c_ref > 0)
    assert (c_ref > 0).sum() > 200
    held = c_ref > 0
    np.testing.assert_allclose(got[1][:, loud][held], ref[1][:, loud][held], rtol=0, atol=1e-3)
    stable = held & (ref[1][:, loud] < 0.12)
    assert stable.sum() > 100
    np.testing.assert_allclose(c_got[stable], c_ref[stable], rtol=2e-4, atol=0)


@pytest.mark.parametrize("name", list(SIGNALS))
@pytest.mark.parametrize("use_stonemask", [True, False])
def test_dio_matches_jax(name, use_stonemask):
    """Every frame's voicing identical; voiced f0 within 1 cent."""
    x = SIGNALS[name]()
    ref = np.asarray(jworld.DioPitchExtractor(use_stonemask=use_stonemask)(x, SR))
    ext = PITCH_EXTRACTORS.build(dict(type="DioPitchExtractor", use_stonemask=use_stonemask),
                                 device="cpu")
    got = ext(x, SR)
    assert got.shape == ref.shape == (len(x) // HOP + 1,)
    assert (ref > 0).sum() > 30
    np.testing.assert_array_equal(got > 0, ref > 0)
    voiced = ref > 0
    assert np.abs(1200 * np.log2(got[voiced] / ref[voiced])).max() <= 1.0
