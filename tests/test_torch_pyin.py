"""PyTorch port vs the JAX package: K8 dense's plain version against pYIN's
and CREPE's Viterbi decoders (exactly), pYIN's observation stage and
transition table, and ``PyinPitchExtractor`` on the tones of
``tests/test_torch_pitch.py`` (voicing identical, voiced f0 within 1 cent).

Observations on a grid of 0.5 make many scores tie: the first state must
win in both. CREPE's cases carry its -inf bins and the bucket's uniform pad
rows."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.extractors import crepe as jcrepe
from fish_diffusion_tpu.extractors import pitch as jpitch
from fish_diffusion_tpu_torch.extractors import pitch
from fish_diffusion_tpu_torch.registry import PITCH_EXTRACTORS
from tests.test_torch_kernels_cuda import dense_case
from tests.test_torch_pitch import HOP, SIGNALS, SR


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pyin_A():
    return pitch._pyin_transition(215, 0.01, 8)


def quantized_obs(rng, T, S, scale=8.0):
    """log observations on a grid of 0.5 in [-scale, 0]: frequent ties."""
    return (np.round(rng.uniform(-scale, 0, (T, S)) * 2) / 2).astype(np.float32)


@pytest.mark.parametrize("T", [1, 2, 57, 300])
def test_dense_reference_equals_pyin_viterbi(pyin_A, T):
    """430 states, pYIN's own transition matrix; quantized observations
    and, for the longer cases, pYIN-like ones (log of binned masses)."""
    rng = np.random.default_rng(T)
    cases = [quantized_obs(rng, T, 430)]
    if T > 2:
        mass = rng.dirichlet(np.full(8, 0.3), T) * rng.uniform(0, 1, (T, 1))
        obs = np.zeros((T, 430), np.float32)
        bins = rng.integers(0, 215, (T, 8))
        for k in range(8):
            obs[np.arange(T), bins[:, k]] += mass[:, k]
        obs[:, 215:] = ((1 - mass.sum(1)) / 215)[:, None]
        cases.append(np.log(obs + 1e-12).astype(np.float32))
    for log_obs in cases:
        ref = np.asarray(jpitch._pyin_viterbi(jnp.asarray(log_obs), jnp.asarray(pyin_A)))
        lo = torch.from_numpy(log_obs)[None]
        got = pitch.viterbi_dense_reference(pitch.pyin_delta0(lo), lo, torch.from_numpy(pyin_A))
        assert got.dtype == torch.int32 and got.shape == (1, T)
        np.testing.assert_array_equal(got[0].numpy(), ref)
        # the wrapper on a CPU tensor is the plain version
        np.testing.assert_array_equal(pitch.pyin_viterbi(lo, torch.from_numpy(pyin_A))[0].numpy(),
                                      ref)


def crepe_log_obs(rng, T_real, T_bucket, quantized):
    """CREPE's decoder input: log_softmax of sigmoid activations (or
    quantized values) with the bins outside [50, 1100] Hz at -inf, then
    uniform pad rows past ``T_real``."""
    lo = max(jcrepe.frequency_to_bin(50.0), 0)
    hi = min(jcrepe.frequency_to_bin(1100.0, np.ceil), 360)
    probs = np.full((T_bucket, 360), -np.inf, np.float32)
    if quantized:
        probs[:T_real, lo:hi] = np.round(rng.uniform(0, 4, (T_real, hi - lo))) / 2
    else:
        probs[:T_real, lo:hi] = rng.uniform(0, 1, (T_real, hi - lo))
    log_obs = np.array(jax.nn.log_softmax(jnp.asarray(probs), axis=1))
    log_obs[T_real:] = np.asarray(-jnp.log(float(360)))
    return log_obs


@pytest.mark.parametrize("T_real,T_bucket,quantized", [
    (1, 1, False), (200, 256, False), (200, 256, True), (256, 256, True)])
def test_dense_reference_equals_crepe_viterbi(T_real, T_bucket, quantized):
    """360 states, CREPE's transition prior: -inf bins pass through, the
    uniform pad rows and the quantized cases tie."""
    rng = np.random.default_rng(T_real + quantized)
    log_obs = crepe_log_obs(rng, T_real, T_bucket, quantized)
    log_trans = np.asarray(jnp.log(jnp.maximum(jnp.asarray(jcrepe._transition_matrix()), 1e-12)))
    ref = np.asarray(jcrepe._viterbi_path(jnp.asarray(log_obs), jnp.asarray(log_trans)))
    lo = torch.from_numpy(log_obs)[None]
    A = torch.from_numpy(log_trans.copy())
    got = pitch.viterbi_dense_reference(pitch.crepe_delta0(lo), lo, A)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    np.testing.assert_array_equal(pitch.crepe_viterbi(lo, A)[0].numpy(), ref)


@pytest.mark.parametrize("kind", ["pyin", "crepe", "flat"])
def test_dense_reference_ties_match_jax(kind):
    """Exact ties in the recursion (an odd state's predecessors j - 1 and
    j + 1; with a constant matrix, every state) and in the final argmax
    (``dense_case``): the first index wins in both packages."""
    delta0, log_obs, log_A = dense_case(kind, 1, 12, seed=1, ties=kind != "flat")
    jax_decode = jcrepe._viterbi_path if kind == "crepe" else jpitch._pyin_viterbi
    ref = np.asarray(jax_decode(jnp.asarray(log_obs[0].numpy()), jnp.asarray(log_A.numpy())))
    got = pitch.viterbi_dense_reference(delta0, log_obs, log_A)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    if kind != "flat":
        assert got[-1] % 2 == 1 and got[-2] == got[-1] - 1


def test_crepe_initial_constant_is_formed_in_float32():
    """delta_0 = -log(S) + obs_0 with -log(360) rounded to float32 as JAX
    rounds it."""
    lo = torch.zeros((1, 3, 360))
    assert pitch.crepe_delta0(lo)[0, 0].item() == float(-jnp.log(float(360)))
    assert pitch.crepe_delta0(lo).shape == (1, 360)


def test_pyin_transition_equals_jax():
    """The host table (float64, then float32): identical."""
    for n_bins, switch, width in ((215, 0.01, 8), (40, 0.05, 3)):
        np.testing.assert_array_equal(pitch._pyin_transition(n_bins, switch, width),
                                      jpitch._pyin_transition(n_bins, switch, width))
    np.testing.assert_array_equal(pitch._beta_cdf_grid(2.0, 18.0),
                                  jpitch._beta_cdf_grid(2.0, 18.0))


@pytest.mark.parametrize("name", list(SIGNALS))
def test_pyin_observations_match_jax(name):
    """Every probability within 1e-5; the frequency of every candidate that
    carries 1e-5 of mass or more within 1e-5 relative (a candidate of
    negligible mass may come and go with a float32 rounding of a trough)."""
    x = SIGNALS[name]()
    cdf = jpitch._beta_cdf_grid(2.0, 18.0)
    ref_f, ref_p = (np.asarray(a) for a in jpitch._pyin_observations(
        jnp.asarray(x), SR, 2048, HOP, 50.0, 1100.0, beta_cdf=jnp.asarray(cdf)))
    got_f, got_p = (a.numpy() for a in pitch._pyin_observations(
        torch.from_numpy(x), SR, 2048, HOP, 50.0, 1100.0, torch.from_numpy(cdf)))
    assert got_f.shape == ref_f.shape == (len(x) // HOP + 1, 8)
    np.testing.assert_allclose(got_p, ref_p, rtol=0, atol=1e-5)
    held = (ref_p >= 1e-5) & (got_p >= 1e-5)
    assert held.sum() > 100
    np.testing.assert_allclose(got_f[held], ref_f[held], rtol=1e-5)


@pytest.fixture(scope="module")
def extractors():
    """One extractor each (the JAX one's decoder compiles per instance)."""
    return jpitch.PyinPitchExtractor(), pitch.PyinPitchExtractor(device="cpu")


@pytest.mark.parametrize("name", list(SIGNALS))
def test_pyin_matches_jax(extractors, name):
    """Every frame's voicing identical; voiced f0 within 1 cent."""
    jext, ext = extractors
    x = SIGNALS[name]()
    ref = np.asarray(jext(x, SR))
    got = ext(x, SR)
    assert got.shape == ref.shape == (len(x) // HOP + 1,)
    assert (ref > 0).sum() > 30
    np.testing.assert_array_equal(got > 0, ref > 0)
    voiced = ref > 0
    assert np.abs(1200 * np.log2(got[voiced] / ref[voiced])).max() <= 1.0


def test_pyin_observation_matrix_matches_jax():
    """The binned observation matrix that feeds the decoder: the masses of
    a bin's candidates added in candidate order, as the JAX scatter-add
    does: the voiced half within 1e-6 of the log (exact but for ``log``'s
    last bits); the unvoiced half, 1 - the sum of the masses (summed in
    another order, and 1 - p loses digits), within 1e-5."""
    rng = np.random.default_rng(3)
    freqs = rng.uniform(40, 1200, (50, 8)).astype(np.float32)
    freqs[:, 4:] = freqs[:, :4] * 1.001  # candidates sharing a bin
    freqs[rng.random((50, 8)) < 0.3] = 0.0
    probs = (rng.dirichlet(np.ones(8), 50) * 0.9).astype(np.float32)
    ext = pitch.PyinPitchExtractor(device="cpu")
    _, got = ext.observations(torch.from_numpy(freqs), torch.from_numpy(probs))
    S = ext._n_bins
    bins = np.where(freqs > 0, np.clip((np.log2(np.maximum(freqs, 1e-6) / 50.0) * 48)
                                       .astype(np.int32), 0, S - 1), 0)
    obs_v = np.asarray(jnp.zeros((50, S)).at[np.arange(50)[:, None], bins].add(probs))
    obs_u = (1 - np.clip(probs.sum(1), 0, 1)) / S
    ref = np.log(np.concatenate([obs_v, np.repeat(obs_u[:, None], S, 1)], 1) + 1e-12)
    np.testing.assert_allclose(got.numpy()[:, :S], ref[:, :S], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:, S:], ref[:, S:], rtol=0, atol=1e-5)
    assert isinstance(PITCH_EXTRACTORS.build(dict(type="PyinPitchExtractor"), device="cpu"),
                      pitch.PyinPitchExtractor)
    assert math.isclose(ext._n_bins, 215)
