"""PyTorch port vs the JAX package: the RefineGAN generator.

- K9, the comb-tooth template (``CombToothSource``: K3's frame-phase scan in
  its linear mode and ``comb_merge``), against ``BlockedCombTooth`` with the
  same noise, and against a float64 evaluation of the same formula;
- ``repeat_expand`` in linear mode (the generator's resampling), up and down;
- ``RefineGANGenerator`` whole, and its parameter gradients against
  ``jax.grad``, with the JAX module's draws injected in call order (the
  template's noise, then the AdaINs' in module order; each ``AdaIN`` of a
  block draws the same shape, so a lookup by shape would give them all one
  noise);
- a template other than the comb and the sine raises (the sine template
  is held in ``tests/test_torch_refinegan_sine.py``).

On the CPU the wrappers run their kernels' plain versions. Inputs come
from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.models.vocoders.refinegan import RefineGANGenerator as JGenerator
from fish_diffusion_tpu.models.vocoders.source import BlockedCombTooth
from fish_diffusion_tpu.ops.tensor import repeat_expand as jrepeat_expand
from fish_diffusion_tpu_torch.convert import refinegan_from_jax
from fish_diffusion_tpu_torch.models.vocoders import source
from fish_diffusion_tpu_torch.models.vocoders.refinegan import RefineGANGenerator
from fish_diffusion_tpu_torch.ops.tensor import repeat_expand

GEN_CFG = dict(sampling_rate=44100, hop_length=16, downsample_rates=(2, 2, 2, 2),
               upsample_rates=(2, 2, 2, 2), num_mels=16, start_channels=4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, ref, tol, what=""):
    """max |got - ref| <= tol * max(|ref|, 1e-30)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), max(np.abs(ref).max(), 1e-30)
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


def in_call_order(draws):
    """A stand-in for ``jax.random.normal`` that hands out ``draws`` in
    order (cyclically), each reshaped to the shape asked for."""
    calls = []

    def normal(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        calls.append(tuple(shape))
        return jnp.asarray(draws[(len(calls) - 1) % len(draws)].reshape(shape))

    return normal, calls


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------


def f0_curve(rng, B, T, sr):
    """Voiced stretches with jumps, unvoiced frames, and f0 near sr / 2."""
    f0 = rng.uniform(80, 800, (B, T)).astype(np.float32)
    f0[:, 5:9] = 0.0
    f0[0, 0] = 0.0
    f0[0, 20] = sr / 2 - 50
    f0[1, 12] = 1500.0
    f0[1, T - 1] = 0.0
    return f0


def comb_float64(f0, noise, sr, hop, amp=0.1, noise_std=0.003):
    """The comb template in float64: per-sample linearly interpolated f0,
    its cumulative phase, ``x = phase - round(phase)``, the sinc comb, the
    voicing gate and the noise."""
    B, T = f0.shape
    f = f0.astype(np.float64)
    fp = np.concatenate([f[:, :1], f[:, :-1]], 1)
    fn = np.concatenate([f[:, 1:], f[:, -1:]], 1)
    pos = (np.arange(hop) + 0.5) / hop - 0.5
    w = np.where(pos < 0, pos + 1, pos)
    fs = (fp[..., None] * np.where(pos < 0, 1 - w, 0) + f[..., None] * np.where(pos < 0, w, 1 - w)
          + fn[..., None] * np.where(pos < 0, 0, w)).reshape(B, -1)
    phase = np.cumsum(fs / sr, axis=1) % 1.0
    x = phase - np.round(phase)
    voiced = fs > 0
    return (np.where(voiced, np.sinc(sr * x / (fs + 1e-3)) * amp, 0.0)
            + np.where(voiced, noise_std, amp / 3) * noise.reshape(B, -1))


@pytest.mark.parametrize("sr,hop,T,tol", [(44100, 16, 40, 1e-5), (8000, 16, 64, 1e-5),
                                          (44100, 32, 24, 3e-5)])
def test_comb_tooth_matches_blocked_comb_tooth(sr, hop, T, tol):
    """The template against ``BlockedCombTooth`` given the same noise:
    <= 1e-5 abs on a 0.1-amplitude signal at hop 16. The JAX module sums
    the phase in float32 over the frame's samples, so its own error grows
    with the hop (3e-5 at hop 32, 1e-4 at hop 256); the port forms the
    phase in float64 and holds the float64 formula to 4e-6 at every hop
    (its frame base is stored in float32, a step of 6e-8 near 1, and the
    comb's slope reaches 0.1 x sr / f0, 55 per unit of phase at 80 Hz)."""
    rng = np.random.default_rng(sr + hop)
    B = 2
    f0 = f0_curve(rng, B, T, sr)
    noise = rng.standard_normal((B, T, hop)).astype(np.float32)
    normal, calls = in_call_order([noise])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        ref = BlockedCombTooth(sampling_rate=sr, hop=hop).apply(
            {}, jnp.asarray(f0), rngs={"noise": jax.random.PRNGKey(0)})
    assert calls == [(B, T, hop)]
    got = source.CombToothSource(sr, hop)(t(f0), t(noise.reshape(B, -1)))
    assert got.shape == (B, T * hop, 1)
    err = np.abs(got.numpy() - np.asarray(ref)).max()
    assert err <= tol, err
    err = np.abs(got.numpy()[..., 0] - comb_float64(f0, noise, sr, hop)).max()
    assert err <= 4e-6, err


def test_linear_phase_base_matches_blocked_phase():
    """K3's frame-phase scan in its linear mode: the phase at each frame's
    first sample less that sample's own advance, against the JAX
    ``blocked_phase`` on linearly interpolated f0 (mod 1, <= 2e-6)."""
    from fish_diffusion_tpu.models.vocoders.source import blocked_phase, sample_f0_blocked

    rng = np.random.default_rng(5)
    sr, hop = 44100, 16
    f0 = f0_curve(rng, 2, 50, sr)
    f0_blk = sample_f0_blocked(jnp.asarray(f0), hop, "linear")
    ref = np.asarray(blocked_phase(f0_blk, sr))[:, :, 0] - np.asarray(f0_blk)[:, :, 0] / sr
    got = source.nsf_phase_base_reference(t(f0), sr, hop, "linear").numpy()
    d = (got - ref) % 1.0
    assert np.minimum(d, 1 - d).max() <= 2e-6
    # the nearest mode (K3 for NSF-HiFiGAN): against ``blocked_phase`` on
    # held f0, and bit for bit the exclusive float64 sum of each frame's
    # frac(float32(f0 / sr) * hop), exact in any order
    near = source.nsf_phase_base_reference(t(f0), sr, hop).numpy()
    f0_held = sample_f0_blocked(jnp.asarray(f0), hop, "nearest")
    ref = np.asarray(blocked_phase(f0_held, sr))[:, :, 0] - np.asarray(f0_held)[:, :, 0] / sr
    d = (near - ref) % 1.0
    assert np.minimum(d, 1 - d).max() <= 2e-6
    adv = np.mod((f0.astype(np.float32) / np.float32(sr) * np.float32(hop)).astype(np.float64),
                 1.0)
    assert np.array_equal(near, np.mod(np.cumsum(adv, axis=1) - adv, 1.0).astype(np.float32))


@pytest.mark.parametrize("src,dst", [(24, 48), (48, 24), (33, 264), (264, 33), (30, 7)])
def test_repeat_expand_linear_matches_jax(src, dst):
    """Linear resampling, align_corners False, up and down (no antialias):
    <= 1e-6 of the input's scale."""
    x = np.random.default_rng(src).standard_normal((2, 3, src)).astype(np.float32)
    close(repeat_expand(t(x), dst), jrepeat_expand(jnp.asarray(x), dst, "linear"), 1e-6,
          "linear")


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


def randomize(tree, seed):
    """Every parameter scaled and shifted at random, so that the weight-norm
    scales, biases and AdaIN weights are not their initial 1 and 0."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + 0.3 * rng.standard_normal(np.shape(a)))
                   + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), tree)


@pytest.fixture(scope="module")
def generator_case():
    """The JAX generator (its default, blocked path), randomised params, an
    input with unvoiced frames, and the draws in call order."""
    rng = np.random.default_rng(0)
    B, T, M = 2, 24, 16
    mel = (rng.standard_normal((B, T, M)) * 0.5 - 2).astype(np.float32)
    f0 = rng.uniform(90, 600, (B, T)).astype(np.float32)
    f0[:, 3:6] = 0.0
    jgen = JGenerator(**GEN_CFG)
    params = randomize(jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(mel), jnp.asarray(f0))["params"], 2)
    shapes = RefineGANGenerator(**GEN_CFG).noise_shapes(B, T)
    draws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return jgen, params, mel, f0, draws


def test_generator_matches_jax(generator_case):
    """The whole generator with the noise injected in call order: <= 1e-5
    of the output's scale. The JAX module draws 25 times, the port's
    ``noise_shapes`` lists the same 25 shapes."""
    jgen, params, mel, f0, draws = generator_case
    normal, calls = in_call_order(draws)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        ref = jax.jit(jgen.apply)({"params": params}, jnp.asarray(mel), jnp.asarray(f0),
                                  rngs={"noise": jax.random.PRNGKey(3)})
    assert len(calls) == len(draws) == 25
    assert [int(np.prod(c)) for c in calls] == [d.size for d in draws]
    tgen = RefineGANGenerator(**GEN_CFG)
    tgen.load_state_dict(refinegan_from_jax(params))
    with torch.no_grad():
        got = tgen(t(mel), t(f0), [t(d) for d in draws])
    assert got.shape == (2, 24 * 16)
    close(got, ref, 1e-5, "wav")


def test_generator_gradients_match_jax_grad(generator_case):
    """d/dparams of sum(y_hat * r) for every parameter (K4's input and
    weight gradients through every conv, the AdaIN weights): <= 1e-3 of
    each tensor's largest gradient."""
    jgen, params, mel, f0, draws = generator_case
    r = np.random.default_rng(7).standard_normal((2, 24 * 16)).astype(np.float32)
    normal, _ = in_call_order(draws)

    def loss(p):
        y = jgen.apply({"params": p}, jnp.asarray(mel), jnp.asarray(f0),
                       rngs={"noise": jax.random.PRNGKey(3)})
        return jnp.sum(y * jnp.asarray(r))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        grads = jax.jit(jax.grad(loss))(params)
    ref = refinegan_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    tgen = RefineGANGenerator(**GEN_CFG)
    tgen.load_state_dict(refinegan_from_jax(params))
    (tgen(t(mel), t(f0), [t(d) for d in draws]) * t(r)).sum().backward()
    got = {name: p.grad for name, p in tgen.named_parameters()}
    assert set(got) == set(ref)
    for name in ref:
        close(got[name], ref[name], 1e-3, name)


def test_generator_draws_from_a_generator_and_rejects_the_sine_template():
    """Without given noise the generator draws it from a ``torch.Generator``
    (the same seed, the same audio), with either template. The sine
    template, once refused, is ported now (K9 sine): what the generator
    rejects is a template that is neither."""
    mel, f0 = torch.randn(1, 8, 16), torch.full((1, 8), 220.0)
    for template in ("comb", "sine"):
        gen = RefineGANGenerator(**GEN_CFG, template_generator=template).init_weights(3)
        with torch.no_grad():
            a = gen(mel, f0, generator=torch.Generator().manual_seed(1))
            b = gen(mel, f0, generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, b) and a.shape == (1, 128) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="'comb' or 'sine'"):
        RefineGANGenerator(**GEN_CFG, template_generator="saw")
