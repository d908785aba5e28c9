"""PyTorch port vs the JAX package: RefineGAN's sine template (K9 sine).

- ``RefineSineSource`` (K3's frame-phase scan in its linear mode and
  ``sine_merge``; on the CPU their plain versions) against the JAX
  ``RefineSineGen`` on ``linear_resize``d f0, with the same start phases
  and noise, for RefineGAN's one harmonic and for three; and against a
  float64 evaluation of the same formula;
- ``RefineGANGenerator(template_generator="sine")`` whole, and its
  parameter gradients (the merge's among them) against ``jax.grad``, the
  JAX module's draws injected in call order;
- three v2 GAN steps with the sine template against the JAX trainer's
  step (one compile), losses within 1e-3 relative, parameters within
  2 * lr * steps, as ``tests/test_torch_refinegan_train.py`` holds the comb
  template's.

Inputs come from numpy with a seed.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.config.config import Config as JConfig
from fish_diffusion_tpu.models.vocoders.refinegan import RefineGANGenerator as JGenerator
from fish_diffusion_tpu.models.vocoders.refinegan import RefineSineGen, linear_resize
from fish_diffusion_tpu_torch.config.config import Config
from fish_diffusion_tpu_torch.convert import discriminators_from_jax, refinegan_from_jax
from fish_diffusion_tpu_torch.models.vocoders import source
from fish_diffusion_tpu_torch.models.vocoders.refinegan import RefineGANGenerator
from fish_diffusion_tpu_torch.training.vocoder_trainer import VocoderTrainer
from tests.test_torch_refinegan import GEN_CFG, close, f0_curve, in_call_order, randomize, t
from tests.test_torch_refinegan_train import SEG, batches, tiny_config

SINE_CFG = dict(GEN_CFG, template_generator="sine")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K9 sine
# ---------------------------------------------------------------------------


def sine_float64(f0, rand_ini, noise, weight, bias, sr, hop, amp=0.1, noise_std=0.003):
    """The sine template in float64: per-sample linearly interpolated f0,
    each harmonic's cumulative phase plus its start phase, sin 2 pi, 0 above
    sr // 2, the voicing gate and the noise, the merge and tanh."""
    B, T = f0.shape
    H = rand_ini.shape[1]
    f = f0.astype(np.float64)
    fp = np.concatenate([f[:, :1], f[:, :-1]], 1)
    fn = np.concatenate([f[:, 1:], f[:, -1:]], 1)
    pos = (np.arange(hop) + 0.5) / hop - 0.5
    w = np.where(pos < 0, pos + 1, pos)
    fs = (fp[..., None] * np.where(pos < 0, 1 - w, 0) + f[..., None] * np.where(pos < 0, w, 1 - w)
          + fn[..., None] * np.where(pos < 0, 0, w)).reshape(B, -1)
    h = np.arange(1, H + 1)
    phase = np.cumsum(fs / sr, axis=1)[..., None] * h + rand_ini[:, None, :]
    sines = np.where(fs[..., None] * h > sr // 2, 0.0, np.sin(2 * np.pi * phase)) * amp
    voiced = (fs > 0)[..., None]
    s = np.where(voiced, sines, 0.0) + np.where(voiced, noise_std, amp / 3) * noise
    return np.tanh(s @ weight + bias)[..., None]


@pytest.mark.parametrize("harmonic_num,hop,T", [(0, 16, 40), (2, 32, 24)])
def test_sine_source_matches_refine_sine_gen(harmonic_num, hop, T):
    """The template against ``RefineSineGen`` on the JAX generator's own
    per-sample f0, the same start phases and noise: <= 2e-5. The JAX module
    sums the phase by a float32 mod-1 scan over samples (its error grows
    with the length, ~1e-6 of phase here, and with the harmonic); the port
    forms it in float64 and holds the float64 formula to 2e-6 (its frame
    base is stored in float32)."""
    rng = np.random.default_rng(hop + harmonic_num)
    sr, B, H = 44100, 2, harmonic_num + 1
    f0 = f0_curve(rng, B, T, sr)
    rand_ini = rng.uniform(size=(B, H)).astype(np.float32)
    rand_ini[:, 0] = 0.0
    noise = rng.standard_normal((B, T * hop, H)).astype(np.float32)
    weight = (rng.standard_normal(H) / np.sqrt(H)).astype(np.float32)
    bias = np.float32(0.05)
    by_shape = {(B, H): rand_ini, (B, T * hop, H): noise}

    def lookup(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        return jnp.asarray(by_shape[tuple(shape)])

    params = {"merge": {"kernel": jnp.asarray(weight[:, None]), "bias": jnp.asarray([bias])}}
    f0_s = linear_resize(jnp.asarray(f0)[:, :, None], T * hop)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lookup)
        mp.setattr(jax.random, "normal", lookup)
        gen = RefineSineGen(sampling_rate=sr, harmonic_num=harmonic_num)
        ref = np.asarray(jax.jit(gen.apply)({"params": params}, f0_s,
                                            rngs={"noise": jax.random.PRNGKey(0)}))

    mod = source.RefineSineSource(sr, hop, harmonic_num)
    with torch.no_grad():
        mod.merge.weight.copy_(t(weight[None]))
        mod.merge.bias.fill_(float(bias))
        got = mod(t(f0), t(noise), rand_ini=t(rand_ini)).numpy()
    assert got.shape == ref.shape == (B, T * hop, 1)
    assert np.abs(got - ref).max() <= 2e-5
    exact = sine_float64(f0, rand_ini.astype(np.float64), noise, weight, bias, sr, hop)
    assert np.abs(got - exact).max() <= 2e-6


def test_sine_merge_gradient_is_the_analytic_one():
    """``sine_merge``'s weight and bias gradients (``_SineMerge``: the
    merge's inputs written by the forward, the tanh and merge gradient in
    torch) equal autograd through the plain version."""
    rng = np.random.default_rng(9)
    B, T, hop, H = 2, 24, 16, 3
    f0 = t(f0_curve(rng, B, T, 44100))
    rand_ini = t(rng.uniform(size=(B, H)))
    rand_ini[:, 0] = 0
    noise = t(rng.standard_normal((B, T * hop, H)))
    g = t(rng.standard_normal((B, T * hop, 1)))
    base = source.nsf_phase_base_reference(f0, 44100, hop, "linear")
    grads = []
    for fn in (source.sine_merge, source.sine_merge_reference):
        w = t([0.5, -0.3, 0.2]).requires_grad_()
        b = torch.zeros(1, requires_grad=True)
        (fn(f0, base, rand_ini, noise, w, b, 44100, hop) * g).sum().backward()
        grads.append((w.grad, b.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the generator with the sine template
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def generator_case():
    """The JAX generator with the sine template (its plain tail: the
    blocked one is held by ``tests/test_torch_refinegan.py``), randomised
    params, an input with unvoiced frames, and the draws
    in call order."""
    rng = np.random.default_rng(1)
    B, T, M = 2, 24, 16
    mel = (rng.standard_normal((B, T, M)) * 0.5 - 2).astype(np.float32)
    f0 = rng.uniform(90, 600, (B, T)).astype(np.float32)
    f0[:, 3:6] = 0.0
    jgen = JGenerator(**SINE_CFG, blocked_tail=False)  # the same function, a faster compile
    params = randomize(jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(mel), jnp.asarray(f0))["params"], 4)
    assert set(params["template_gen"]) == {"merge"}
    shapes = RefineGANGenerator(**SINE_CFG).noise_shapes(B, T)
    assert shapes[0] == (B, T * 16, 1)
    draws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return jgen, params, mel, f0, draws


def test_sine_generator_matches_jax(generator_case):
    """The whole generator with the noise injected in call order: <= 1e-5
    of the output's scale (25 draws, the template's first)."""
    jgen, params, mel, f0, draws = generator_case
    normal, calls = in_call_order(draws)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        ref = jax.jit(jgen.apply)({"params": params}, jnp.asarray(mel), jnp.asarray(f0),
                                  rngs={"noise": jax.random.PRNGKey(3)})
    assert calls[0] == (2, 24 * 16, 1) and len(calls) == len(draws) == 25
    tgen = RefineGANGenerator(**SINE_CFG)
    tgen.load_state_dict(refinegan_from_jax(params))
    with torch.no_grad():
        got = tgen(t(mel), t(f0), [t(d) for d in draws])
    close(got, ref, 1e-5, "wav")


def test_sine_generator_gradients_match_jax_grad(generator_case):
    """d/dparams of sum(y_hat * r) for every parameter, the sine template's
    merge weight and bias among them (through the tanh; the sines are
    stop-gradient): <= 1e-3 of each tensor's largest gradient."""
    jgen, params, mel, f0, draws = generator_case
    r = np.random.default_rng(8).standard_normal((2, 24 * 16)).astype(np.float32)
    normal, _ = in_call_order(draws)

    def loss(p):
        y = jgen.apply({"params": p}, jnp.asarray(mel), jnp.asarray(f0),
                       rngs={"noise": jax.random.PRNGKey(3)})
        return jnp.sum(y * jnp.asarray(r))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        grads = jax.jit(jax.grad(loss))(params)
    ref = refinegan_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    assert {"template_gen.merge.weight", "template_gen.merge.bias"} <= set(ref)
    tgen = RefineGANGenerator(**SINE_CFG)
    tgen.load_state_dict(refinegan_from_jax(params))
    (tgen(t(mel), t(f0), [t(d) for d in draws]) * t(r)).sum().backward()
    got = {name: p.grad for name, p in tgen.named_parameters()}
    assert set(got) == set(ref)
    for name in ref:
        close(got[name], ref[name], 1e-3, name)


# ---------------------------------------------------------------------------
# three v2 GAN steps with the sine template
# ---------------------------------------------------------------------------


MRD = ((64, 8, 32),)


def sine_config(jax_side: bool = False):
    """The tiny v2 config with the sine template, one MPD period, one MRD
    resolution and one mel scale (the losses' other scales are held by
    ``tests/test_torch_refinegan_train.py``); the JAX side takes its plain
    (not blocked) tail, the same function. Both cuts shorten the JAX
    step's compile."""
    cfg = copy.deepcopy(tiny_config())
    cfg["model"]["generator"]["template_generator"] = "sine"
    cfg["model"]["mpd"]["periods"] = (2,)
    cfg["model"]["mrd"]["resolutions"] = MRD
    cfg["model"]["multi_scale_mels"] = [(128, 16, 64)]
    if jax_side:
        cfg["model"]["generator"]["blocked_tail"] = False
    return cfg


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Three steps of the JAX trainer's compiled v2 step with the sine
    template (float32, one compile), the generator's normal draws injected
    in call order (the start-phase draw is the JAX key's own: with one
    harmonic its only column is set to 0)."""
    from fish_diffusion_tpu.parallel import make_mesh
    from fish_diffusion_tpu.parallel.distributed import make_global_batch
    from fish_diffusion_tpu.training.vocoder_trainer import VocoderTrainer as JTrainer
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(axis_shapes=(1,), axis_names=("data",), devices=jax.devices()[:1])
    trainer = JTrainer(JConfig(**sine_config(jax_side=True)), log_dir=str(tmp_path_factory.mktemp("j")),
                       mesh=mesh, steps_per_epoch=1)
    data = batches(3, seed=5)
    state = jax.device_put(trainer.init_state(data[0], seed=3), NamedSharding(mesh, P()))
    init = jax.tree_util.tree_map(np.array, (state.params_g, state.params_d))
    assert "template_gen" in init[0]

    gen_cfg = {k: v for k, v in sine_config()["model"]["generator"].items() if k != "type"}
    shapes = RefineGANGenerator(**gen_cfg).noise_shapes(2, SEG // 16)
    rng = np.random.default_rng(23)
    draws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    normal, calls = in_call_order(draws)
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        for batch in data:
            sb = make_global_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
            state, m = trainer._train_step(state, sb, jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
    assert len(calls) == 2 * len(draws)  # traced once: the D phase's call, the G phase's
    final = jax.tree_util.tree_map(np.array, (state.params_g, state.params_d))
    return init, final, metrics, data, [torch.from_numpy(d) for d in draws]


def test_three_sine_v2_gan_steps_match_jax(jax_run, tmp_path):
    (params_g, params_d), (final_g, final_d), ref, data, draws = jax_run
    trainer = VocoderTrainer(Config(**sine_config()), log_dir=str(tmp_path),
                             steps_per_epoch=1, device="cpu")
    assert trainer.generator.template_generator == "sine"
    batch0 = {k: torch.from_numpy(v) for k, v in data[0].items()}
    assert [tuple(d.shape) for d in trainer.draw(batch0, torch.Generator())][0] == \
        (2, SEG, 1)
    state = trainer.init_state(seed=0)
    state.params_g.load_state_dict(refinegan_from_jax(params_g))
    sd, _ = discriminators_from_jax(params_d, {}, resolutions=MRD)
    state.params_d.load_state_dict(sd)

    for step, batch in enumerate(data):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        state, metrics = trainer._train_step(state, batch, draws)
        for key, want in ref[step].items():
            if key.startswith("loss"):
                got = float(metrics[key])
                assert abs(got - want) <= 1e-3 * abs(want), (step, key, got, want)
    lr, steps = 2e-4, 3
    want_g = refinegan_from_jax(final_g)
    got_g = state.params_g.state_dict()
    assert set(got_g) == set(want_g)
    for k in want_g:
        err = (got_g[k] - want_g[k]).abs().max().item()
        assert err <= 2 * lr * steps, (k, err)
    want_d, _ = discriminators_from_jax(final_d, {}, resolutions=MRD)
    for k, v in state.params_d.state_dict().items():
        assert (v - want_d[k]).abs().max().item() <= 2 * lr * steps, k
