"""PyTorch port vs the JAX package: the iSTFTNet vocoder.

- ``ISTFTNetGenerator`` through ``convert.istft_net_from_jax`` against the
  JAX generator at narrow widths (32 initial channels, 16 mels, upsample
  4 x 4, istft hop 8), with rand_ini and noise injected: spec and phase;
- ``ISTFTNet.spec2wav`` at full width (the wrapper's own: 512 initial
  channels, ups 8 x 8, n_fft 16, hop 8) on a 32-frame mel;
- one ``SVCInference.forward`` of a 32-frame segment with the iSTFTNet
  vocoder, both servers built from ``configs/svc_hubert_soft.py`` cut as
  in ``tests/test_torch_svc.py`` with ``model.vocoder`` overridden to
  ``ISTFTNet``.

The two wrapper cases share one draw of the vocoder's random inputs, so
that the JAX vocoder compiles once (a jit bakes injected draws into its
trace). On the CPU the port runs its kernels' plain versions (K3, K4, K5
istft).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.config import Config as JConfig
from fish_diffusion_tpu.inference.svc import SVCInference as JSVCInference
from fish_diffusion_tpu.models.vocoders.istft_net import ISTFTNetGenerator as JGenerator
from fish_diffusion_tpu_torch.config import Config
from fish_diffusion_tpu_torch.convert import (
    diffsinger_from_jax,
    hubert_soft_from_jax,
    istft_net_from_jax,
)
from fish_diffusion_tpu_torch.inference.svc import SVCInference
from fish_diffusion_tpu_torch.models.vocoders.istft_net import ISTFTNet, ISTFTNetGenerator
from tests.test_torch_svc import CONFIG, randomize, request, tiny
from tests.test_torch_vocoder import draws, f0_curve

SR, HOP, TRUNK = 44100, 512, 64
SEG_FRAMES = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_generator_matches_jax(monkeypatch):
    """Narrow generator (trunk rate 16 samples a frame, 16 + 1 frames of
    the short STFT per mel frame), same weights and draws: spec <= 1e-4
    relative to its largest value (exp of the conv), phase <= 1e-5."""
    rng = np.random.default_rng(11)
    B, T, M = 2, 12, 16
    cfg = dict(num_mels=M, sampling_rate=SR, hop_size=128, upsample_rates=(4, 4),
               upsample_kernel_sizes=(8, 8), upsample_initial_channel=32)
    mel = (rng.standard_normal((B, T, M)) * 0.5 - 2).astype(np.float32)
    f0 = f0_curve(rng, B, T)
    lookup, (rand_ini, noise) = draws(rng, B, T, 16)
    jgen = JGenerator(**cfg)
    params = randomize(jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(mel), jnp.asarray(f0))["params"], 2)
    monkeypatch.setattr(jax.random, "uniform", lookup)
    monkeypatch.setattr(jax.random, "normal", lookup)
    ref_spec, ref_phase = (np.asarray(a) for a in jax.jit(jgen.apply)(
        {"params": params}, jnp.asarray(mel), jnp.asarray(f0),
        rngs={"noise": jax.random.PRNGKey(3)}))

    tgen = ISTFTNetGenerator(**cfg)
    tgen.load_state_dict(istft_net_from_jax(params))
    with torch.inference_mode():
        spec, phase = tgen(torch.from_numpy(mel), torch.from_numpy(f0), rand_ini, noise)
    assert spec.shape == ref_spec.shape == (B, 9, T * 16 + 1)
    assert np.abs(spec.numpy() - ref_spec).max() <= 1e-4 * np.abs(ref_spec).max()
    assert np.abs(phase.numpy() - ref_phase).max() <= 1e-5


# ---------------------------------------------------------------------------
# full width: the wrapper and the server
# ---------------------------------------------------------------------------


def vocoder_draws(rng, B, T):
    """The source's draws at trunk rate: rand_ini [B, 9], noise (JAX's
    blocked [B, T, 64, 9], the port's [B, T * 64, 9]) and the JAX source's
    unused extra noise [B, T * 64, 1]."""
    rand_ini = rng.uniform(size=(B, 9)).astype(np.float32)
    noise = rng.standard_normal((B, T, TRUNK, 9)).astype(np.float32)
    extra = rng.standard_normal((B, T * TRUNK, 1)).astype(np.float32)
    jax_draws = {rand_ini.shape: rand_ini, noise.shape: noise, extra.shape: extra}
    torch_draws = {rand_ini.shape: rand_ini, (B, T * TRUNK, 9): noise.reshape(B, -1, 9)}
    return jax_draws, torch_draws


def inject(monkeypatch, jax_draws, torch_draws):
    """``jax.random`` and ``torch.rand``/``torch.randn`` hand out the given
    arrays by shape."""
    def from_jax(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        return jnp.asarray(jax_draws[tuple(shape)])

    def from_torch(shape, *args, **kwargs):
        return torch.from_numpy(torch_draws[tuple(shape)].copy())

    monkeypatch.setattr(jax.random, "normal", from_jax)
    monkeypatch.setattr(jax.random, "uniform", from_jax)
    monkeypatch.setattr(torch, "randn", from_torch)
    monkeypatch.setattr(torch, "rand", from_torch)


def with_istft_net(cfg):
    cfg = tiny(cfg)
    cfg.model.vocoder.update(type="ISTFTNet", checkpoint_path=None, random_init=True)
    return cfg


@pytest.fixture(scope="module")
def engines():
    """Both servers with the iSTFTNet vocoder at full width (the JAX
    wrapper's own widths), the same seeded weights everywhere, and one draw
    of the vocoder's random inputs for a 32-frame segment."""
    jeng = JSVCInference(with_istft_net(JConfig.fromfile(CONFIG)))
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
    jeng.vocoder.params = randomize(jeng.vocoder.params, 3)

    teng = SVCInference(with_istft_net(Config.fromfile(CONFIG)), device="cpu")
    assert isinstance(teng.vocoder, ISTFTNet) and not teng.vocoder.use_natural_log
    teng.text_features_extractor.load_state_dict(
        hubert_soft_from_jax(jeng.text_features_extractor.params))
    teng.load_state_dict(diffsinger_from_jax(jeng.params))
    teng.vocoder.generator.load_state_dict(istft_net_from_jax(jeng.vocoder.params))
    return jeng, teng, vocoder_draws(np.random.default_rng(1), 1, SEG_FRAMES)


def test_spec2wav_matches_jax(engines, monkeypatch):
    """A 32-frame log10 mel through both wrappers (mel x 2.30259, the
    generator, K5 istft): 32 x 512 samples, <= 1e-4 of the peak (iSTFTNet
    has no output tanh)."""
    jeng, teng, (jax_draws, torch_draws) = engines
    rng = np.random.default_rng(2)
    mel = (rng.standard_normal((1, SEG_FRAMES, 128)) * 0.5 - 2).astype(np.float32)
    f0 = f0_curve(rng, 1, SEG_FRAMES)
    inject(monkeypatch, jax_draws, torch_draws)
    ref = np.asarray(jeng.vocoder.spec2wav(jnp.asarray(mel), jnp.asarray(f0)))
    got = teng.vocoder.spec2wav(torch.from_numpy(mel), torch.from_numpy(f0)).numpy()
    assert got.shape == ref.shape == (1, SEG_FRAMES * HOP)
    assert np.isfinite(got).all() and np.abs(ref).max() > 1e-3
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_forward_with_istft_net_matches_jax(engines, monkeypatch):
    """``forward`` of one 32-frame segment with its f0 (bucket 128, 100
    UniPC evals, the iSTFTNet vocoder at the segment's 32 frames): the
    input's length, <= 2e-3 of the peak in wav. The random tiny DiffSVC's
    mel spans about +-130 (log10), so the random vocoder's output is far
    above 1 (iSTFTNet has no output tanh): the check is relative."""
    jeng, teng, (jax_draws, torch_draws) = engines
    rng = np.random.default_rng(4)
    audio, f0 = request(rng, SEG_FRAMES * HOP)
    x_T = rng.standard_normal((1, 128, 128)).astype(np.float32)
    inject(monkeypatch, {**jax_draws, x_T.shape: x_T}, {**torch_draws, x_T.shape: x_T})
    ref = jeng.forward(audio, jeng.parse_speaker(0), pitches=f0)
    got = teng.forward(audio, teng.parse_speaker(0), pitches=f0)
    assert got.shape == ref.shape == audio.shape
    assert np.isfinite(got).all() and np.abs(ref).max() > 1e-3
    assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max()
