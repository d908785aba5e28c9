"""PyTorch port vs the JAX package: the PLMS and naive samplers and shallow
diffusion (UniPC, PLMS, naive from a noised input mel) through
``GaussianDiffusion``, with a WaveNet 4 x 32 denoiser, the same weights and
the same random draws.

The draws are made once with numpy and handed to both sides in the port's
order (x_T unless shallow, the warm-start noise when shallow, then one noise
per naive step). On the JAX side ``jax.random.split`` is replaced so that
every key carries the index of its draw (the naive scan body is traced
once, so the index has to travel in the key); on the torch side
``torch.randn`` pops a queue. On the CPU the port runs the plain versions
of its K2 kernels."""

from collections import defaultdict, deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.models.diffusion import GaussianDiffusion as JDiffusion
from fish_diffusion_tpu_torch.convert import wavenet_from_jax
from fish_diffusion_tpu_torch.models import diffusion as tdiff

B, T, M, D = 2, 32, 128, 16
TIMESTEPS, INTERVAL = 1000, 20
CFG = dict(
    mel_channels=M, timesteps=TIMESTEPS, sampler_interval=INTERVAL,
    spec_min=[-5], spec_max=[0],
    denoiser=dict(type="WaveNetDenoiser", mel_channels=M, d_encoder=D,
                  residual_channels=32, residual_layers=4, dilation_cycle=2,
                  use_linear_bias=True),
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(tree, seed):
    """Seeded numpy draws for every leaf (the flax init zeroes biases and
    the WaveNet output projection): kernels N(0, 1/fan_in), vectors
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    new = []
    for x in leaves:
        shape = np.shape(x)
        scale = shape[-2] ** -0.5 if len(shape) >= 2 else 0.1
        new.append((rng.standard_normal(shape) * scale).astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, new)


def inject_draws(monkeypatch, mel_shape, x_T=None, skip=None, steps=(), other=None):
    """Hand the same draws to ``jax.random`` and ``torch.randn``/``torch.rand``.

    Draws of the mel's shape go by index: 0 = x_T, 1 = the warm-start
    noise, 2 + i = naive step i. JAX's ``split(key, 3)`` in the diffusion
    module gives the keys [2], [0], [1] and every ``split(key)`` after it
    gives (key + 1, key), so step i's key carries 2 + i. Other shapes (the
    vocoder's) go by shape. The torch side pops the same arrays in order."""
    other = other or {}
    zeros = np.zeros(mel_shape, np.float32)
    table = jnp.asarray(np.stack(
        [zeros if x_T is None else x_T, zeros if skip is None else skip, *steps]
    ))

    def code(i):
        return jnp.asarray([0, i], jnp.uint32)

    def fake_split(key, num=2):
        if num == 3:
            return jnp.stack([code(2), code(0), code(1)])
        step = jnp.asarray([0, 1], jnp.uint32)
        return jnp.stack([key + step] + [key] * (num - 1))

    def fake_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == tuple(mel_shape):
            return table[key[1]]
        return jnp.asarray(other[tuple(shape)])

    def fake_uniform(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        return jnp.asarray(other[tuple(shape)])

    queues = defaultdict(deque)
    for a in [x_T, skip, *steps]:
        if a is not None:
            queues[tuple(mel_shape)].append(a)
    torch_other = {}
    for shape, a in other.items():
        if len(shape) == 4:  # the JAX NSF noise [B, frames, hop, 9]
            shape, a = (shape[0], shape[1] * shape[2], shape[3]), a.reshape(
                shape[0], shape[1] * shape[2], shape[3])
        torch_other[shape] = a

    def fake_torch(shape, *args, **kwargs):
        shape = tuple(shape)
        a = queues[shape].popleft() if queues[shape] else torch_other[shape]
        return torch.from_numpy(np.array(a, np.float32))

    monkeypatch.setattr(jax.random, "split", fake_split)
    monkeypatch.setattr(jax.random, "normal", fake_normal)
    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(torch, "randn", fake_torch)
    monkeypatch.setattr(torch, "rand", fake_torch)
    return queues


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    features = rng.standard_normal((B, T, D)).astype(np.float32)
    jd = JDiffusion(**CFG)
    params = jax.jit(lambda rngs, f, m: jd.init(rngs, f, m, method=jd.train_step))(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        jnp.asarray(features), jnp.asarray(rng.uniform(-5, 0, (B, T, M)), jnp.float32),
    )["params"]
    params = randomize(params, 3)
    td = tdiff.GaussianDiffusion(**CFG)
    td.denoise_fn.load_state_dict(wavenet_from_jax(params["denoise_fn"]))
    return jd, params, td


@pytest.mark.parametrize("predictor,skip_steps", [
    ("plms", 0), ("naive", 0), ("unipc", 600), ("plms", 600), ("naive", 600),
])
def test_sampler_matches_jax(models, monkeypatch, predictor, skip_steps):
    """Reverse diffusion with padding masks (lengths 32 and 22); shallow
    from an input mel in [-5, 0] when ``skip_steps`` > 0: mel <= 1e-4 max
    abs (float32 sums in another order through 20-50 dependent steps; the
    unclipped PLMS mel from x_T reaches |mel| ~130 with random weights,
    where 1e-4 is ~13 float32 ulps)."""
    jd, params, td = models
    rng = np.random.default_rng(7)
    features = rng.standard_normal((B, T, D)).astype(np.float32)
    masks = np.arange(T)[None, :] >= np.asarray([T, 22])[:, None]
    shape = (B, T, M)
    original = rng.uniform(-5, 0, shape).astype(np.float32) if skip_steps else None
    n_steps = len(range(0, TIMESTEPS - skip_steps, INTERVAL))
    draw = lambda: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    x_T = None if skip_steps else draw()
    skip = draw() if skip_steps else None
    steps = [draw() for _ in range(n_steps)] if predictor == "naive" else []
    queues = inject_draws(monkeypatch, shape, x_T, skip, steps)

    ref = np.asarray(jd.apply(
        {"params": params}, jnp.asarray(features), skip_steps=skip_steps,
        original_mel=None if original is None else jnp.asarray(original),
        noise_predictor=predictor, x_masks=jnp.asarray(masks),
        cond_masks=jnp.asarray(masks), rngs={"diffusion": jax.random.PRNGKey(5)},
    ))
    with torch.inference_mode():
        got = td(torch.from_numpy(features), skip_steps=skip_steps,
                 original_mel=None if original is None else torch.from_numpy(original),
                 noise_predictor=predictor, x_masks=torch.from_numpy(masks),
                 cond_masks=torch.from_numpy(masks)).numpy()
    assert not queues[shape], "the port drew fewer mel-shaped draws than given"
    assert np.isfinite(ref).all() and np.abs(ref - ref.mean()).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_step_updates_match_their_formulas():
    """The plain K2-PLMS and K2-naive updates against the JAX package's
    formulas written out in numpy float32: <= 1e-6."""
    rng = np.random.default_rng(3)
    x, e, h2, h1, h0, z = (rng.standard_normal((2, 5, 8)).astype(np.float32)
                           for _ in range(6))
    coeffs = tdiff.ScheduleCoefficients(np.linspace(1e-4, 0.02, 100))
    acp = coeffs.alphas_cumprod.astype(np.float32)
    t, t_prev = 40, 30
    a_t, a_p = acp[t], acp[t_prev]
    noise = (55 * e - 59 * h2 + 37 * h1 - 9 * h0) / 24
    want = x + (a_p - a_t) * (
        (1 / (np.sqrt(a_t) * (np.sqrt(a_t) + np.sqrt(a_p)))) * x
        - 1 / (np.sqrt(a_t) * (np.sqrt((1 - a_p) * a_t) + np.sqrt((1 - a_t) * a_p)))
        * noise
    )
    got = tdiff.plms_update(*(torch.from_numpy(a) for a in (x, e, h2, h1, h0)),
                            *tdiff.PLMS_WEIGHTS[2], *tdiff.plms_transfer(acp, t, t_prev))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)

    table = tdiff.naive_step_table(coeffs)
    for t in (0, 40):
        f32 = lambda name: getattr(coeffs, name).astype(np.float32)[t]  # noqa: E731
        x0 = np.clip(f32("sqrt_recip_alphas_cumprod") * x
                     - f32("sqrt_recipm1_alphas_cumprod") * e, -1, 1)
        sigma = (t > 0) * np.exp(0.5 * f32("posterior_log_variance_clipped"))
        want = f32("posterior_mean_coef1") * x0 + f32("posterior_mean_coef2") * x + sigma * z
        got = tdiff.ddpm_update(*(torch.from_numpy(a) for a in (x, e, z)),
                                *(float(table[k][t]) for k in ("a", "b", "c1", "c2", "sigma")))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
