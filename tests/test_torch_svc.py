"""The whole slice: the port's ``SVCInference`` against the JAX one, both
built from a tiny override of ``configs/svc_hubert_soft.py`` (HubertSoft cut
to 1 layer, WaveNet 4 x 32, NSF-HiFiGAN initial channels 32 with one
resblock fan; 100 UniPC evals as configured), with the same weights
(carried across by ``fish_diffusion_tpu_torch.convert``) and the same random
draws injected into both: ``forward``/``forward_batch`` with caller-supplied
f0 or Harvest's, the file-to-file ``inference`` (Harvest, ParselMouth, pYIN
or ``pitches_path``; UniPC, PLMS, naive; shallow diffusion), CREPE's
time-aligned crop (and the JAX server's crop that keeps the first ~43% of
CREPE's curve), and the port's CLI."""

import inspect
import json
import pickle
from collections import defaultdict, deque
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.config import Config as JConfig
from fish_diffusion_tpu.extractors import crepe as jcrepe
from fish_diffusion_tpu.inference.svc import SVCInference as JSVCInference
from fish_diffusion_tpu.registry import PITCH_EXTRACTORS as J_PITCH_EXTRACTORS
from fish_diffusion_tpu_torch.config import Config
from fish_diffusion_tpu_torch.convert import (
    crepe_from_jax,
    diffsinger_from_jax,
    hubert_soft_from_jax,
    nsf_hifigan_from_jax,
)
from fish_diffusion_tpu_torch.extractors.crepe import CrepePitchExtractor
from fish_diffusion_tpu_torch.extractors.feature import (
    ChineseHubert,
    ChineseHubertSoft,
    ContentVec,
    HubertSoft,
)
from fish_diffusion_tpu_torch.extractors.pitch import (
    ParselMouthPitchExtractor,
    PyinPitchExtractor,
    YinPitchExtractor,
)
from fish_diffusion_tpu_torch.extractors.world import (
    DioPitchExtractor,
    HarvestPitchExtractor,
)
from fish_diffusion_tpu_torch.inference import cli
from fish_diffusion_tpu_torch.inference.svc import SVCInference
from fish_diffusion_tpu_torch.models.vocoders.istft_net import ISTFTNet
from fish_diffusion_tpu_torch.models.vocoders.nsf_hifigan import NsfHifiGAN
from fish_diffusion_tpu_torch.ops.mel import LogMelSpectrogram
from fish_diffusion_tpu_torch.registry import PITCH_EXTRACTORS
from fish_diffusion_tpu_torch.utils.audio import load_wav, save_wav
from tests.test_torch_crepe import randomized_variables

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

    teng = SVCInference(tiny(Config.fromfile(CONFIG)), device="cpu")
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


def test_load_checkpoint_without_ema_matches_jax(engines, monkeypatch, tmp_path):
    """A pickle of a ``TrainState`` built without ``ema_momentum``,
    ``{"params": tree, "ema_params": None}``: both servers load ``params``
    (the port's weights equal the tree's), and the same request gives the
    same mel (<= 1e-3 of its scale) and wav (<= 2e-3). The request repeats
    ``test_forward_with_speaker_mix_matches_jax``'s, draws included, so the
    JAX server's compiled sampler serves both."""
    jeng, teng = engines
    tree = jax.tree_util.tree_map(np.asarray, jeng.params)
    path = tmp_path / "state.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": tree, "ema_params": None}, f)
    jeng.load_checkpoint(path)
    teng.load_checkpoint(path)
    for k, v in diffsinger_from_jax(tree).items():
        assert torch.equal(teng.model.state_dict()[k], v), k

    mels = defaultdict(list)
    for side, eng in (("jax", jeng), ("port", teng)):
        spec2wav = eng.vocoder.spec2wav

        def keep(mel, *args, _side=side, _fn=spec2wav, **kwargs):
            mels[_side].append(np.asarray(mel))
            return _fn(mel, *args, **kwargs)

        monkeypatch.setattr(eng.vocoder, "spec2wav", keep)
    rng = np.random.default_rng(5)
    audio, f0 = request(rng, 40000)
    inject_draws(monkeypatch, rng, B=1, n_frames=40000 // HOP, mel_frames=128)
    mix = "0:0.6,1:0.4"
    ref = jeng.forward(audio, jeng.parse_speaker(mix), pitches=f0)
    got = teng.forward(audio, teng.parse_speaker(mix), pitches=f0)
    (mel_ref,), (mel_got,) = mels["jax"], mels["port"]
    assert mel_got.shape == mel_ref.shape == (1, 40000 // HOP, 128)
    assert np.abs(mel_got - mel_ref).max() <= 1e-3 * np.abs(mel_ref).max()
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_jax_server_cannot_load_a_bare_tree(engines, tmp_path):
    """A JAX-package fault the port does not copy: the JAX server's
    ``load_checkpoint`` reads ``state["params"]`` from any dict without an
    EMA, so a pickle of the bare params tree raises ``KeyError`` there;
    the port loads it."""
    jeng, teng = engines
    tree = jax.tree_util.tree_map(np.asarray, jeng.params)
    path = tmp_path / "bare.pkl"
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    with pytest.raises(KeyError, match="params"):
        jeng.load_checkpoint(path)
    teng.load_checkpoint(path)
    for k, v in diffsinger_from_jax(tree).items():
        assert torch.equal(teng.model.state_dict()[k], v), k


def test_request_without_f0_raises(engines, monkeypatch):
    """Without an f0 curve and with a pitch extractor that is not ported,
    a request says so."""
    _, teng = engines
    monkeypatch.setattr(teng, "pitch_extractor", None)
    monkeypatch.setattr(teng, "pitch_extractor_type", "RMVPitchExtractor")
    audio = np.zeros(20000, np.float32)
    with pytest.raises(NotImplementedError, match="RMVPitchExtractor.*not ported"):
        teng.forward(audio, teng.parse_speaker(0))
    with pytest.raises(NotImplementedError, match="RMVPitchExtractor"):
        teng.forward_batch([audio], teng.parse_speaker(0))


# ---------------------------------------------------------------------------
# Harvest, shallow diffusion, the samplers, file to file
# ---------------------------------------------------------------------------


def inject_queue(monkeypatch, jeng, mel_shape, mel_draws, calls, seed):
    """Same draws on both sides, by index for the mel-shaped ones and by
    shape for the vocoder's.

    ``mel_draws`` = (x_T or None, warm-start noise or None, naive step
    noises): one sample call's mel-shaped draws, in the port's order. On the
    JAX side ``split(key, 3)`` in the diffusion module gives keys carrying
    indices 2, 0, 1 and each later ``split(key)`` gives (key + 1, key), so
    the naive scan's step i reads index 2 + i. The torch side pops a queue
    that repeats the call's draws ``calls`` times (the JAX sample function
    is traced once per bucket, so every segment of a bucket sees the same
    draws there). The vocoder's draws (phases [B, 9], noise [B, T * hop, 9])
    are made per shape from ``seed``."""
    x_T, skip, steps = mel_draws
    zeros = np.zeros(mel_shape, np.float32)
    table = jnp.asarray(np.stack(
        [zeros if x_T is None else x_T, zeros if skip is None else skip, *steps]))
    made = {}

    def other(shape, uniform):
        key = (tuple(shape), uniform)
        if key not in made:
            rng = np.random.default_rng([seed, *shape, uniform])
            made[key] = (rng.uniform(size=shape) if uniform
                         else rng.standard_normal(shape)).astype(np.float32)
        return made[key]

    def code(i):
        return jnp.asarray([0, i], jnp.uint32)

    def fake_split(key, num=2):
        if num == 3:
            return jnp.stack([code(2), code(0), code(1)])
        return jnp.stack([key + jnp.asarray([0, 1], jnp.uint32)] + [key] * (num - 1))

    def fake_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == tuple(mel_shape):
            return table[key[1]]
        return jnp.asarray(other(shape, False))

    def fake_uniform(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        return jnp.asarray(other(shape, True))

    queue = deque()
    for _ in range(calls):
        queue.extend(a for a in (x_T, skip, *steps) if a is not None)

    def fake_torch(uniform):
        def draw(shape, *args, **kwargs):
            shape = tuple(shape)
            if shape == tuple(mel_shape):
                return torch.from_numpy(queue.popleft().copy())
            if not uniform and len(shape) == 3 and shape[2] == 9:
                B, n, dim = shape
                return torch.from_numpy(other((B, n // HOP, HOP, dim), False).reshape(shape))
            return torch.from_numpy(other(shape, uniform).copy())
        return draw

    # fresh JAX traces, so that no earlier test's draws are baked in
    jeng._sample_cache = {}
    jeng.vocoder._spec2wav = jax.jit(jeng.vocoder._spec2wav_impl)
    monkeypatch.setattr(jax.random, "split", fake_split)
    monkeypatch.setattr(jax.random, "normal", fake_normal)
    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(torch, "randn", fake_torch(False))
    monkeypatch.setattr(torch, "rand", fake_torch(True))
    return queue


def mel_draws(rng, shape, predictor, skip_steps, interval=10, timesteps=1000):
    draw = lambda: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    x_T = None if skip_steps else draw()
    skip = draw() if skip_steps else None
    n_steps = len(range(0, timesteps - skip_steps, interval)) if predictor == "naive" else 0
    return x_T, skip, [draw() for _ in range(n_steps)]


def two_phrase_song(path, seed):
    """~4.8 s at 44.1 kHz: two 1.8 s sung phrases (vibrato, two partials,
    a noise floor) between stretches of digital silence -> two segments."""
    rng = np.random.default_rng(seed)
    parts = [np.zeros(int(0.2 * SR))]
    for f in (220.0, 262.0):
        t = np.arange(int(1.8 * SR)) / SR
        phase = 2 * np.pi * np.cumsum(f * (1 + 0.01 * np.sin(2 * np.pi * 5 * t))) / SR
        parts += [0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase)
                  + 0.004 * rng.standard_normal(len(t)), np.zeros(int(0.5 * SR))]
    save_wav(path, np.concatenate(parts).astype(np.float32), SR)
    return load_wav(path)[0]


@pytest.mark.parametrize("predictor,skip_steps", [
    ("unipc", 0), ("unipc", 500), ("plms", 0), ("naive", 500),
])
def test_inference_matches_jax(engines, monkeypatch, tmp_path, predictor, skip_steps):
    """File to file with Harvest pitch: two segments (bucket 256), each a
    ``forward`` with seed ``seed + i``; shallow diffusion from the input's
    own mel (K5 on the card) when ``skip_steps`` > 0: wav <= 2e-3 max abs."""
    jeng, teng = engines
    audio = two_phrase_song(tmp_path / "in.wav", seed=8)
    rng = np.random.default_rng(9)
    queue = inject_queue(monkeypatch, jeng, (1, 256, 128),
                         mel_draws(rng, (1, 256, 128), predictor, skip_steps),
                         calls=2, seed=10)
    kw = dict(speaker=0, skip_steps=skip_steps, noise_predictor=predictor, seed=3)
    ref = jeng.inference(tmp_path / "in.wav", tmp_path / "ref.wav", **kw)
    got = teng.inference(tmp_path / "in.wav", tmp_path / "out.wav", **kw)
    assert not queue, "the port drew fewer mel-shaped draws than expected"
    assert got.shape == ref.shape == audio.shape
    assert np.abs(ref).max() > 0.01 and np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, ref, atol=2e-3)
    written, sr = load_wav(tmp_path / "out.wav")
    assert sr == SR and written.shape == audio.shape


@pytest.mark.parametrize("extractor", ["ParselMouthPitchExtractor", "PyinPitchExtractor"])
def test_inference_with_config_extractor_matches_jax(engines, monkeypatch, tmp_path,
                                                     extractor):
    """File to file with ``preprocessing.pitch_extractor`` set to
    ParselMouth (K8-cand's plain version on the CPU) or pYIN (K8 pYIN's):
    wav <= 2e-3 max abs."""
    jeng, teng = engines
    cfg = dict(type=extractor, keep_zeros=False)
    monkeypatch.setattr(jeng, "pitch_extractor", J_PITCH_EXTRACTORS.build(cfg))
    monkeypatch.setattr(teng, "pitch_extractor", PITCH_EXTRACTORS.build(cfg, device="cpu"))
    audio = two_phrase_song(tmp_path / "in.wav", seed=17)
    rng = np.random.default_rng(18)
    queue = inject_queue(monkeypatch, jeng, (1, 256, 128),
                         mel_draws(rng, (1, 256, 128), "unipc", 0), calls=2, seed=19)
    kw = dict(speaker=0, seed=5)
    ref = jeng.inference(tmp_path / "in.wav", tmp_path / "ref.wav", **kw)
    got = teng.inference(tmp_path / "in.wav", tmp_path / "out.wav", **kw)
    assert not queue
    assert got.shape == ref.shape == audio.shape and np.abs(ref).max() > 0.01
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.fixture(scope="module")
def crepe_pair():
    """CREPE tiny in both packages with the same (randomised) weights."""
    variables = randomized_variables(seed=1)
    jext = jcrepe.CrepePitchExtractor(model="tiny")
    jext.variables = variables
    ext = PITCH_EXTRACTORS.build(dict(type="CrepePitchExtractor", model="tiny"),
                                 device="cpu")
    ext.load_state_dict(crepe_from_jax(variables))
    return jext, ext


def crepe_segment(seed):
    """A 1.8 s phrase at 44.1 kHz: 155 mel frames, bucket 256."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(1.8 * SR)) / SR
    phase = 2 * np.pi * np.cumsum(230.0 * (1 + 0.01 * np.sin(2 * np.pi * 5 * t))) / SR
    return (0.3 * np.sin(phase) + 0.004 * rng.standard_normal(len(t))).astype(np.float32)


def test_crepe_segment_f0_is_time_aligned(engines, crepe_pair, monkeypatch):
    """With CREPE, the segment's f0 is the JAX extractor's curve on the
    bucket-padded audio, cropped to the 5 ms frames that cover the segment
    (ceil(n * 16000 / 44100 / 80)) and stretched to the mel frames:
    voicing identical, f0 within 1 cent."""
    _, teng = engines
    jext, ext = crepe_pair
    monkeypatch.setattr(teng, "pitch_extractor", ext)
    audio = crepe_segment(20)
    mel_len, bucket = len(audio) // HOP, 256
    got = teng._prepare_segment(audio, 0.0, None, bucket)["pitches_true"]

    padded = np.pad(audio, (0, bucket * HOP - len(audio)))
    f0_raw = np.asarray(jext(padded, SR, pad_to=None))
    n_true = int(np.ceil(len(audio) * 16000 / SR / 80))
    assert n_true == ext.frame_count(len(audio), SR) == 360 and len(f0_raw) == 595
    ref = jext.post_process(audio, SR, f0_raw[:n_true], mel_len)
    assert got.shape == ref.shape == (mel_len,) and (ref > 0).sum() > 100
    np.testing.assert_array_equal(got > 0, ref > 0)
    voiced = ref > 0
    assert np.abs(1200 * np.log2(got[voiced] / ref[voiced])).max() <= 1.0


def test_jax_server_crops_crepe_to_its_first_frames(engines, crepe_pair, monkeypatch):
    """The JAX server's crop (``fish_diffusion_tpu/inference/svc.py:255``)
    keeps ceil(n / 512) frames of any extractor's curve. CREPE gives 200
    frames a second (one per 80 samples at 16 kHz), so for a 1.8 s segment
    it keeps 156 of the 360 that cover the segment (43%) and stretches them
    over the whole segment; the port crops by the extractor's own frames
    (the test above), and so departs from the JAX server here."""
    jeng, teng = engines
    jext, ext = crepe_pair
    monkeypatch.setattr(jeng, "pitch_extractor", jext)
    audio = crepe_segment(20)
    mel_len, bucket = len(audio) // HOP, 256
    ref = jeng._prepare_segment(audio, 0.0, None, bucket)["pitches_true"]

    padded = np.pad(audio, (0, bucket * HOP - len(audio)))
    f0_raw = np.asarray(jext(padded, SR, pad_to=None))
    n_hop = int(np.ceil(len(audio) / HOP))
    assert n_hop == 156 and n_hop / ext.frame_count(len(audio), SR) < 0.44
    np.testing.assert_array_equal(ref, jext.post_process(audio, SR, f0_raw[:n_hop], mel_len))
    monkeypatch.setattr(teng, "pitch_extractor", ext)
    got = teng._prepare_segment(audio, 0.0, None, bucket)["pitches_true"]
    assert not np.allclose(got, ref)


@pytest.mark.parametrize("suffix", [".json", ".npy"])
def test_inference_with_pitches_path_matches_jax(engines, monkeypatch, tmp_path, suffix):
    """The f0 curve from a file (a .json list or .npy array of frame f0s
    over the whole input) instead of Harvest: wav <= 2e-3 max abs."""
    jeng, teng = engines
    audio = two_phrase_song(tmp_path / "in.wav", seed=11)
    rng = np.random.default_rng(12)
    f0 = rng.uniform(150, 400, len(audio) // HOP).astype(np.float32)
    f0[rng.random(len(f0)) < 0.2] = 0.0
    pitches = tmp_path / f"f0{suffix}"
    if suffix == ".json":
        pitches.write_text(json.dumps(f0.tolist()))
    else:
        np.save(pitches, f0)
    queue = inject_queue(monkeypatch, jeng, (1, 256, 128),
                         mel_draws(rng, (1, 256, 128), "unipc", 0), calls=2, seed=13)
    kw = dict(speaker=1, pitches_path=str(pitches), seed=4)
    ref = jeng.inference(tmp_path / "in.wav", tmp_path / "ref.wav", **kw)
    got = teng.inference(tmp_path / "in.wav", tmp_path / "out.wav", **kw)
    assert not queue
    assert got.shape == ref.shape == audio.shape and np.abs(ref).max() > 0.01
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_request_without_f0_runs_harvest(engines, monkeypatch):
    """``forward`` and ``forward_batch`` without an f0 curve run Harvest
    (the config's extractor) on the bucket-padded audio: wav <= 2e-3."""
    jeng, teng = engines
    rng = np.random.default_rng(14)
    audio, _ = request(rng, 117 * HOP)
    audio = audio * np.linspace(0.2, 1.0, len(audio), dtype=np.float32)
    assert isinstance(teng.pitch_extractor, HarvestPitchExtractor)
    queue = inject_queue(monkeypatch, jeng, (1, 128, 128),
                         mel_draws(rng, (1, 128, 128), "unipc", 0), calls=2, seed=15)
    ref = jeng.forward(audio, jeng.parse_speaker(0), seed=1)
    got = teng.forward(audio, teng.parse_speaker(0), seed=1)
    ref_b = jeng.forward_batch([audio], jeng.parse_speaker(0), seed=1)[0]
    got_b = teng.forward_batch([audio], teng.parse_speaker(0), seed=1)[0]
    assert not queue
    for g, r in ((got, ref), (got_b, ref_b)):
        assert g.shape == r.shape == audio.shape and np.abs(r).max() > 0.01
        np.testing.assert_allclose(g, r, atol=2e-3)


def test_cli_runs_on_the_cpu(engines, tmp_path, capsys):
    """``python -m fish_diffusion_tpu_torch.inference.cli`` at tiny dims with
    ``--device cpu``: a config file whose ``_base_`` is
    ``configs/svc_hubert_soft.py``, random HubertSoft and vocoder weights,
    a pickle of the JAX package's params; PLMS and shallow diffusion."""
    jeng, _ = engines
    (tmp_path / "tiny.py").write_text(f"""
_base_ = [{str(CONFIG)!r}]
preprocessing = dict(text_features_extractor=dict(num_layers=1, random_init=True))
model = dict(
    diffusion=dict(denoiser=dict(residual_channels=32, residual_layers=4, d_encoder=32)),
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
    audio = two_phrase_song(tmp_path / "in.wav", seed=16)
    cli.main(["--config", str(tmp_path / "tiny.py"), "--checkpoint",
              str(tmp_path / "params.pkl"), "--input", str(tmp_path / "in.wav"),
              "--output", str(tmp_path / "out.wav"), "--sampler", "plms",
              "--skip-steps", "500", "--sampler-interval", "50", "--device", "cpu"])
    out, sr = load_wav(tmp_path / "out.wav")
    assert sr == SR and out.shape == audio.shape
    assert np.isfinite(out).all() and 0 < np.abs(out).max() <= 1.0
    assert "2 segments" in capsys.readouterr().out


def test_entry_points_default_to_cuda():
    """Every entry point runs on the card unless the caller asks for the
    CPU; without a card, a default build raises rather than falling back."""
    extractors = (HarvestPitchExtractor, ParselMouthPitchExtractor, PyinPitchExtractor,
                  CrepePitchExtractor, DioPitchExtractor, YinPitchExtractor)
    hubert = (HubertSoft, ChineseHubertSoft, ChineseHubert, ContentVec)
    for cls in (SVCInference, NsfHifiGAN, ISTFTNet, LogMelSpectrogram) + hubert + extractors:
        assert inspect.signature(cls).parameters["device"].default == "cuda", cls
    assert cli.build_parser().get_default("device") == "cuda"
    if torch.cuda.is_available():
        assert LogMelSpectrogram().device.type == "cuda"
    else:
        front_ends = tuple(lambda cls=cls: cls(num_layers=1) for cls in hubert)
        for build in (LogMelSpectrogram, ISTFTNet) + front_ends + extractors:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
