"""PyTorch port vs the JAX package: the HuBERT content features with the
same weights (carried across by ``convert.hubert_from_jax``): HubertSoft
(the post-norm tower) and the pre-norm front ends ChineseHubertSoft (top-k
gates of 10 and 25), ChineseHubert and ContentVec.

The width stays 768 (the JAX heads' input is fixed at 768); the tower is
cut to 1-2 layers."""

import numpy as np
import pytest
import torch

from fish_diffusion_tpu.extractors import feature as jfeature
from fish_diffusion_tpu.extractors.feature import HubertSoft as JHubertSoft
from fish_diffusion_tpu.extractors.feature import resample_linear as j_resample
from fish_diffusion_tpu_torch.convert import hubert_from_jax, hubert_soft_from_jax
from fish_diffusion_tpu_torch.extractors import feature
from fish_diffusion_tpu_torch.extractors.feature import HubertSoft, resample_linear
from fish_diffusion_tpu_torch.registry import FEATURE_EXTRACTORS


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


def tone(seed):
    """1 s of 44.1 kHz audio: a 220 Hz tone in noise."""
    t = np.arange(44100) / 44100
    rng = np.random.default_rng(seed)
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(44100))
    return audio.astype(np.float32)


def test_hubert_soft_matches_jax(extractors):
    """1 s of 44.1 kHz audio -> [1, 256, T] soft units: <= 1e-4 relative to
    the largest feature."""
    jax_ext, port = extractors
    audio = tone(1)
    ref = jax_ext(audio, 44100)
    got = port(audio, 44100)
    assert got.shape == ref.shape == (1, 256, 49)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, err


def test_hubert_soft_needs_weights():
    with pytest.raises(RuntimeError, match="no weights"):
        HubertSoft(num_layers=1, device="cpu")(np.zeros(16000, np.float32), 16000)


# the pre-norm front ends: (name, JAX kwargs, port kwargs, channels)
PRE_NORM = {
    "ChineseHubertSoft gate 10": ("ChineseHubertSoft", dict(num_layers=1, gate_size=10), 256),
    "ChineseHubertSoft gate 25": ("ChineseHubertSoft", dict(num_layers=1, gate_size=25), 256),
    "ChineseHubert": ("ChineseHubert", dict(num_layers=2), 768),
    "ContentVec layer 1": ("ContentVec", dict(num_layers=2, output_layer=1), 256),
}


@pytest.fixture(scope="module")
def pre_norm_extractors():
    """Each pre-norm front end in both packages with the same random JAX
    weights (one JAX ChineseHubertSoft's params serve both gates)."""
    out, soft_params = {}, None
    for label, (name, kwargs, _) in PRE_NORM.items():
        jext = getattr(jfeature, name)(**kwargs)
        if name == "ChineseHubertSoft" and soft_params is not None:
            jext.params = soft_params
        else:
            jext.init_random()
        soft_params = jext.params if name == "ChineseHubertSoft" else soft_params
        port = FEATURE_EXTRACTORS.build(dict(type=name, **kwargs), device="cpu")
        port.load_state_dict(hubert_from_jax(jext.params))
        out[label] = (jext, port)
    return out


@pytest.mark.parametrize("label", list(PRE_NORM))
def test_pre_norm_front_end_matches_jax(pre_norm_extractors, label):
    """1 s of 44.1 kHz audio through the pre-norm tower (no norm after the
    positional conv, none after the last layer) and the front end's head:
    <= 1e-4 relative to the largest feature; after the top-k gate the kept
    set is the JAX one (gate_size channels a frame, more on ties)."""
    jext, port = pre_norm_extractors[label]
    _, kwargs, channels = PRE_NORM[label]
    audio = tone(2)
    ref = np.asarray(jext(audio, 44100))
    got = port(audio, 44100)
    assert got.shape == ref.shape == (1, channels, 49)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, err
    if "gate_size" in kwargs:
        kept = ref != 0
        np.testing.assert_array_equal(got != 0, kept)
        assert (kept.sum(axis=1) >= kwargs["gate_size"]).all()
        assert kept.sum(axis=1).min() == kwargs["gate_size"]


def test_pre_norm_tower_has_no_outer_norms():
    """The pre-norm tower holds no ``encoder.layer_norm`` (the JAX tower has
    neither ``pre_norm`` nor a final norm); the post-norm one does, and
    HubertSoft's state dict keys are unchanged."""
    pre = feature.HubertHeadModel(num_layers=1, layer_norm_first=True)
    post = feature.HubertSoftModel(num_layers=1)
    assert "encoder.layer_norm.weight" not in pre.state_dict()
    assert "encoder.layer_norm.weight" in post.state_dict()
    assert set(post.state_dict()) - set(pre.state_dict()) == {
        "encoder.layer_norm.weight", "encoder.layer_norm.bias", "proj.weight", "proj.bias"}
    assert hubert_soft_from_jax is hubert_from_jax
