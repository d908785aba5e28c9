"""The ConvNeXt serving slice: the port's ``SVCInference`` against the JAX
one, both built from a tiny override of ``configs/denoiser_cn_hubert.py``
(ChineseHubertSoft cut to 1 layer with its gate of 10, ConvNext 4 x 32 x
mlp 2, NSF-HiFiGAN initial channels 32 with one resblock fan; ParselMouth
pitch; 100 UniPC evals as configured), with the same weights (carried
across by ``fish_diffusion_tpu_torch.convert``) and the same random draws
injected into both: ``forward`` with f0, the file-to-file ``inference``
with the config's ParselMouth, in full and shallow, and the port's CLI on
the CPU; then ``configs/svc_cn_hubert_soft.py`` (WaveNet with
ChineseHubertSoft's gate of 25) through ``forward``."""

import pickle
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
    hubert_from_jax,
    nsf_hifigan_from_jax,
)
from fish_diffusion_tpu_torch.extractors.feature import ChineseHubertSoft
from fish_diffusion_tpu_torch.extractors.pitch import ParselMouthPitchExtractor
from fish_diffusion_tpu_torch.inference import cli
from fish_diffusion_tpu_torch.inference.svc import SVCInference
from fish_diffusion_tpu_torch.models.convnext import ConvNext
from fish_diffusion_tpu_torch.utils.audio import load_wav
from tests import test_torch_svc as svc

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
CN_CONFIG = CONFIGS / "denoiser_cn_hubert.py"
SOFT_CONFIG = CONFIGS / "svc_cn_hubert_soft.py"
HIDDEN, HOP = svc.HIDDEN, svc.HOP


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_convnext(cfg):
    """ChineseHubertSoft at 1 layer (no checkpoint), ConvNext 4 x 32 x 2,
    the encoders at 32, the tiny NSF-HiFiGAN of ``test_torch_svc``."""
    cfg.preprocessing.text_features_extractor.update(num_layers=1, checkpoint_path=None)
    m = cfg.model
    m.diffusion.denoiser.update(dim=32, mlp_factor=2, num_layers=4, condition_dim=HIDDEN)
    for name in ("text_encoder", "speaker_encoder", "pitch_encoder"):
        m[name]["output_size"] = HIDDEN
    m.vocoder.update(checkpoint_path=None, generator_config=dict(
        upsample_initial_channel=32, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3, 5),),
    ))
    return cfg


def tiny_soft(cfg):
    """``configs/svc_cn_hubert_soft.py`` as ``test_torch_svc`` cuts
    ``svc_hubert_soft.py``, ChineseHubertSoft at 1 layer."""
    cfg = svc.tiny(cfg)
    cfg.preprocessing.text_features_extractor.update(checkpoint_path=None)
    return cfg


def build_pair(jcfg, cfg):
    """Both servers with the JAX server's random weights (every leaf
    redrawn, so that zero-initialised layers are live)."""
    jeng = JSVCInference(jcfg)
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
    jeng.params = svc.randomize(params, 1)
    jeng.vocoder.params = svc.randomize(jeng.vocoder.init_random(jax.random.PRNGKey(2)), 3)

    teng = SVCInference(cfg, device="cpu")
    teng.text_features_extractor.load_state_dict(
        hubert_from_jax(jeng.text_features_extractor.params))
    teng.load_state_dict(diffsinger_from_jax(jeng.params))
    teng.vocoder.generator.load_state_dict(nsf_hifigan_from_jax(jeng.vocoder.params))
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    return build_pair(tiny_convnext(JConfig.fromfile(CN_CONFIG)),
                      tiny_convnext(Config.fromfile(CN_CONFIG)))


def test_config_builds_the_convnext_slice(engines):
    """The config builds a ConvNext denoiser, ChineseHubertSoft with its
    gate of 10 and ParselMouth (without zeros) in the port."""
    _, teng = engines
    assert isinstance(teng.model.diffusion.denoise_fn, ConvNext)
    assert isinstance(teng.text_features_extractor, ChineseHubertSoft)
    assert teng.text_features_extractor.model.gate_size == 10
    assert isinstance(teng.pitch_extractor, ParselMouthPitchExtractor)


def keep_mels(monkeypatch, engines):
    """Record the mel each server hands its vocoder."""
    mels = {"jax": [], "port": []}
    for side, eng in zip(mels, engines):
        spec2wav = eng.vocoder.spec2wav

        def keep(mel, *args, _side=side, _fn=spec2wav, **kwargs):
            mels[_side].append(np.asarray(mel))
            return _fn(mel, *args, **kwargs)

        monkeypatch.setattr(eng.vocoder, "spec2wav", keep)
    return mels


def assert_mels_close(mels):
    assert len(mels["jax"]) == len(mels["port"]) > 0
    for got, ref in zip(mels["port"], mels["jax"]):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_forward_with_f0_matches_jax(engines, monkeypatch):
    """One 40000-sample segment with its f0 (bucket 128): mel <= 1e-3 of
    its scale, wav <= 2e-3 max abs."""
    jeng, teng = engines
    mels = keep_mels(monkeypatch, engines)
    rng = np.random.default_rng(5)
    audio, f0 = svc.request(rng, 40000)
    svc.inject_draws(monkeypatch, rng, B=1, n_frames=40000 // HOP, mel_frames=128)
    ref = jeng.forward(audio, jeng.parse_speaker(1), pitches=f0)
    got = teng.forward(audio, teng.parse_speaker(1), pitches=f0)
    assert_mels_close(mels)
    # ``forward`` vocodes the segment's whole frames: 78 x 512 samples
    assert got.shape == ref.shape == ((len(audio) // HOP) * HOP,)
    assert np.abs(ref).max() > 0.01
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("skip_steps", [0, 500], ids=["full", "shallow"])
def test_inference_with_parselmouth_matches_jax(engines, monkeypatch, tmp_path, skip_steps):
    """File to file with the config's ParselMouth pitch (K8-cand's plain
    version on the CPU): two segments (bucket 256), in full and shallow
    from the input's own mel (K5's plain version): each segment's mel <=
    1e-3 of its scale, wav <= 2e-3 max abs."""
    jeng, teng = engines
    audio = svc.two_phrase_song(tmp_path / "in.wav", seed=21 + skip_steps)
    rng = np.random.default_rng(22)
    queue = svc.inject_queue(monkeypatch, jeng, (1, 256, 128),
                             svc.mel_draws(rng, (1, 256, 128), "unipc", skip_steps),
                             calls=2, seed=23)
    mels = keep_mels(monkeypatch, engines)
    kw = dict(speaker=0, skip_steps=skip_steps, seed=6)
    ref = jeng.inference(tmp_path / "in.wav", tmp_path / "ref.wav", **kw)
    got = teng.inference(tmp_path / "in.wav", tmp_path / "out.wav", **kw)
    assert not queue, "the port drew fewer mel-shaped draws than expected"
    assert_mels_close(mels)
    assert got.shape == ref.shape == audio.shape
    assert np.abs(ref).max() > 0.01 and np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_cli_runs_the_convnext_config_on_the_cpu(engines, tmp_path, capsys):
    """``python -m fish_diffusion_tpu_torch.inference.cli`` on a config
    whose ``_base_`` is ``configs/denoiser_cn_hubert.py`` at tiny dims,
    ``--device cpu``, a pickle of the JAX server's ConvNext params
    (``load_checkpoint`` takes the ConvNeXt tree), random ChineseHubertSoft
    and vocoder weights; UniPC at interval 50."""
    jeng, _ = engines
    (tmp_path / "tiny.py").write_text(f"""
_base_ = [{str(CN_CONFIG)!r}]
preprocessing = dict(text_features_extractor=dict(num_layers=1, checkpoint_path=None,
                                                  random_init=True))
model = dict(
    diffusion=dict(denoiser=dict(dim=32, mlp_factor=2, num_layers=4, condition_dim=32)),
    text_encoder=dict(output_size=32),
    speaker_encoder=dict(output_size=32),
    pitch_encoder=dict(output_size=32),
    vocoder=dict(checkpoint_path=None, random_init=True, generator_config=dict(
        upsample_initial_channel=32, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3, 5),))),
)
""")
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump({"params": jax.tree_util.tree_map(np.asarray, jeng.params)}, f)
    audio = svc.two_phrase_song(tmp_path / "in.wav", seed=24)
    cli.main(["--config", str(tmp_path / "tiny.py"), "--checkpoint",
              str(tmp_path / "params.pkl"), "--input", str(tmp_path / "in.wav"),
              "--output", str(tmp_path / "out.wav"), "--sampler-interval", "50",
              "--device", "cpu"])
    out, sr = load_wav(tmp_path / "out.wav")
    assert sr == svc.SR and out.shape == audio.shape
    assert np.isfinite(out).all() and 0 < np.abs(out).max() <= 1.0
    assert "2 segments" in capsys.readouterr().out


def test_svc_cn_hubert_soft_forward_matches_jax(monkeypatch):
    """``configs/svc_cn_hubert_soft.py``: ChineseHubertSoft with its gate of
    25 before the WaveNet denoiser; one segment with its f0: mel <= 1e-3 of
    its scale, wav <= 2e-3 max abs."""
    jcfg, cfg = tiny_soft(JConfig.fromfile(SOFT_CONFIG)), tiny_soft(Config.fromfile(SOFT_CONFIG))
    jeng, teng = build_pair(jcfg, cfg)
    assert teng.text_features_extractor.model.gate_size == 25
    mels = keep_mels(monkeypatch, (jeng, teng))
    rng = np.random.default_rng(7)
    audio, f0 = svc.request(rng, 40000)
    svc.inject_draws(monkeypatch, rng, B=1, n_frames=40000 // HOP, mel_frames=128)
    ref = jeng.forward(audio, jeng.parse_speaker(0), pitches=f0)
    got = teng.forward(audio, teng.parse_speaker(0), pitches=f0)
    assert_mels_close(mels)
    # ``forward`` vocodes the segment's whole frames: 78 x 512 samples
    assert got.shape == ref.shape == ((len(audio) // HOP) * HOP,)
    assert np.abs(ref).max() > 0.01
    np.testing.assert_allclose(got, ref, atol=2e-3)
