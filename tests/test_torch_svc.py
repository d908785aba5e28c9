"""The whole slice: the port's ``SVCInference`` against the JAX one, both
built from a tiny override of ``configs/svc_hubert_soft.py`` (HubertSoft cut
to 1 layer, WaveNet 4 x 32, NSF-HiFiGAN initial channels 32 with one
resblock fan; 100 UniPC evals as configured), with the same weights
(carried across by ``fish_diffusion_tpu_torch.convert``), caller-supplied
f0, and the same random draws injected into both."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.config import Config as JConfig
from fish_diffusion_tpu.inference.svc import SVCInference as JSVCInference
from fish_diffusion_tpu_torch.config import Config
from fish_diffusion_tpu_torch.convert import (
    diffsinger_from_jax,
    hubert_soft_from_jax,
    nsf_hifigan_from_jax,
)
from fish_diffusion_tpu_torch.inference.svc import SVCInference

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "svc_hubert_soft.py"
SR, HOP, HIDDEN = 44100, 512, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(cfg):
    cfg.preprocessing.text_features_extractor["num_layers"] = 1
    m = cfg.model
    m.diffusion.denoiser.update(residual_channels=32, residual_layers=4,
                                d_encoder=HIDDEN)
    for name in ("text_encoder", "speaker_encoder", "pitch_encoder"):
        m[name]["output_size"] = HIDDEN
    m.vocoder.update(checkpoint_path=None, generator_config=dict(
        upsample_initial_channel=32, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3, 5),),
    ))
    return cfg


def randomize(tree, seed):
    """Seeded draws for every leaf, so that zero-initialised layers (the
    WaveNet output projection, the biases) are live: kernels N(0, 1/fan_in),
    vectors N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    new = []
    for x in leaves:
        shape = np.shape(x)
        fan_in = int(np.prod(shape[:-1])) if len(shape) >= 2 else 0
        scale = fan_in ** -0.5 if fan_in else 0.1
        new.append((rng.standard_normal(shape) * scale).astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, new)


@pytest.fixture(scope="module")
def engines():
    jeng = JSVCInference(tiny(JConfig.fromfile(CONFIG)))
    jeng.text_features_extractor.init_random()
    rng = np.random.default_rng(0)
    init = dict(
        speakers=jnp.zeros((1,), jnp.int32),
        contents=jnp.asarray(rng.standard_normal((1, 16, 256)), jnp.float32),
        mel=jnp.asarray(rng.uniform(-4, 0, (1, 16, 128)), jnp.float32),
        pitches=jnp.full((1, 16), 220.0, jnp.float32),
    )
    params = jax.jit(jeng.model.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)}, **init
    )["params"]
    jeng.params = randomize(params, 1)
    jeng.vocoder.params = randomize(jeng.vocoder.init_random(jax.random.PRNGKey(2)), 3)

    teng = SVCInference(tiny(Config.fromfile(CONFIG)))
    teng.text_features_extractor.load_state_dict(
        hubert_soft_from_jax(jeng.text_features_extractor.params)
    )
    teng.load_state_dict(diffsinger_from_jax(jeng.params))
    teng.vocoder.generator.load_state_dict(nsf_hifigan_from_jax(jeng.vocoder.params))
    return jeng, teng


def request(rng, n_samples):
    t = np.arange(n_samples) / SR
    audio = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.standard_normal(n_samples)
    f0 = rng.uniform(150, 400, n_samples // HOP).astype(np.float32)
    f0[rng.random(len(f0)) < 0.2] = 0.0
    return audio.astype(np.float32), f0


def inject_draws(monkeypatch, rng, B, n_frames, mel_frames):
    """Draw x_T, the NSF initial phases and noise once with numpy; hand them
    to ``jax.random`` and ``torch.rand``/``torch.randn`` by shape."""
    hop_samples = n_frames * HOP
    x_T = rng.standard_normal((B, mel_frames, 128)).astype(np.float32)
    rand_ini = rng.uniform(size=(B, 9)).astype(np.float32)
    noise = rng.standard_normal((B, n_frames, HOP, 9)).astype(np.float32)
    extra = rng.standard_normal((B, hop_samples, 1)).astype(np.float32)
    jax_draws = {x_T.shape: x_T, rand_ini.shape: rand_ini, noise.shape: noise,
                 extra.shape: extra}
    torch_draws = {x_T.shape: x_T, rand_ini.shape: rand_ini,
                   (B, hop_samples, 9): noise.reshape(B, hop_samples, 9)}

    def from_jax(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        return jnp.asarray(jax_draws[tuple(shape)])

    def from_torch(shape, *args, **kwargs):
        return torch.from_numpy(torch_draws[tuple(shape)].copy())

    monkeypatch.setattr(jax.random, "normal", from_jax)
    monkeypatch.setattr(jax.random, "uniform", from_jax)
    monkeypatch.setattr(torch, "randn", from_torch)
    monkeypatch.setattr(torch, "rand", from_torch)


def test_forward_batch_matches_jax(engines, monkeypatch):
    """2 segments of different lengths in one bucket (128 frames):
    wav <= 2e-3 max abs."""
    jeng, teng = engines
    rng = np.random.default_rng(4)
    (a1, f1), (a2, f2) = request(rng, 50000), request(rng, 40000)
    inject_draws(monkeypatch, rng, B=2, n_frames=128, mel_frames=128)
    ref = jeng.forward_batch([a1, a2], jeng.parse_speaker(0),
                             pitches_list=[f1, f2])
    got = teng.forward_batch([a1, a2], teng.parse_speaker(0),
                             pitches_list=[f1, f2])
    for g, r, a in zip(got, ref, (a1, a2)):
        assert g.shape == r.shape == a.shape
        assert np.abs(r).max() > 0.01
        np.testing.assert_allclose(g, r, atol=2e-3)


def test_forward_with_speaker_mix_matches_jax(engines, monkeypatch):
    """One segment with the speaker mix "0:0.6,1:0.4"; ``forward`` vocodes
    at the true length: wav <= 2e-3 max abs."""
    jeng, teng = engines
    rng = np.random.default_rng(5)
    audio, f0 = request(rng, 40000)
    inject_draws(monkeypatch, rng, B=1, n_frames=40000 // HOP, mel_frames=128)
    mix = "0:0.6,1:0.4"
    np.testing.assert_allclose(teng.parse_speaker(mix).numpy(),
                               np.asarray(jeng.parse_speaker(mix)), atol=1e-7)
    ref = jeng.forward(audio, jeng.parse_speaker(mix), pitches=f0)
    got = teng.forward(audio, teng.parse_speaker(mix), pitches=f0)
    assert got.shape == ref.shape and np.abs(ref).max() > 0.01
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_request_without_f0_raises(engines):
    _, teng = engines
    audio = np.zeros(20000, np.float32)
    with pytest.raises(NotImplementedError, match="HarvestPitchExtractor.*Queue 1 item 9"):
        teng.forward(audio, teng.parse_speaker(0))
    with pytest.raises(NotImplementedError, match="HarvestPitchExtractor"):
        teng.forward_batch([audio], teng.parse_speaker(0))
