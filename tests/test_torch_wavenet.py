"""PyTorch port vs the JAX package: the WaveNet denoiser (one eval) and
the full UniPC reverse diffusion, with the same weights (carried across by
``fish_diffusion_tpu_torch.convert``) and the same x_T.

On the CPU the port runs the plain versions of its kernels (K1, K2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.models.diffusion import GaussianDiffusion as JDiffusion
from fish_diffusion_tpu.models.wavenet import WaveNet as JWaveNet
from fish_diffusion_tpu_torch.convert import wavenet_from_jax
from fish_diffusion_tpu_torch.models.diffusion import GaussianDiffusion
from fish_diffusion_tpu_torch.models.wavenet import WaveNet


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


def masks_for(lens, T):
    return np.arange(T)[None, :] >= np.asarray(lens)[:, None]


@pytest.mark.parametrize("hoisted", [False, True], ids=["unhoisted", "hoisted"])
def test_wavenet_eval_matches_jax(hoisted):
    """One denoiser eval, 4 layers x 64 channels, dilation cycle 4, T=64,
    with padding masks: <= 1e-4 max abs."""
    rng = np.random.default_rng(0)
    B, T, M, D = 2, 64, 128, 32
    x = rng.standard_normal((B, T, M)).astype(np.float32)
    t = np.array([500.0, 37.0], np.float32)
    cond = rng.standard_normal((B, T, D)).astype(np.float32)
    masks = masks_for([T, 40], T)

    jnet = JWaveNet(mel_channels=M, d_encoder=D, residual_channels=64,
                    residual_layers=4, use_linear_bias=True, dilation_cycle=4)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), *args,
                                x_masks=jnp.asarray(masks),
                                cond_masks=jnp.asarray(masks))["params"]
    params = randomize(params, 1)
    p = {"params": params}
    if hoisted:
        stack = jnet.apply(p, jnp.asarray(cond), jnp.asarray(masks),
                           method=jnet.project_conditioner)
        ref = jnet.apply(p, args[0], args[1], stack, x_masks=jnp.asarray(masks),
                         cond_is_projected=True)
    else:
        ref = jnet.apply(p, *args, x_masks=jnp.asarray(masks),
                         cond_masks=jnp.asarray(masks))

    tnet = WaveNet(M, D, 64, 4, True, 4)
    tnet.load_state_dict(wavenet_from_jax(params))
    xt, tt, ct, mt = (torch.from_numpy(a) for a in (x, t, cond, masks))
    with torch.inference_mode():
        if hoisted:
            got = tnet(xt, tt, None, x_masks=mt, plan=tnet.prepare(ct, mt))
        else:
            got = tnet(xt, tt, ct, x_masks=mt, cond_masks=mt)
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0.1  # the random output projection is live
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_unipc_sample_matches_jax(monkeypatch):
    """Full UniPC reverse diffusion, 100 denoiser evals of a tiny WaveNet,
    same x_T: mel <= 1e-3 max abs (float32 sums taken in another order,
    through 100 dependent steps)."""
    rng = np.random.default_rng(2)
    B, T, M, D = 2, 32, 16, 16
    cfg = dict(
        mel_channels=M, timesteps=1000, sampler_interval=10,
        spec_min=[-5], spec_max=[0],
        denoiser=dict(type="WaveNetDenoiser", mel_channels=M, d_encoder=D,
                      residual_channels=32, residual_layers=2,
                      dilation_cycle=2, use_linear_bias=True),
    )
    features = rng.standard_normal((B, T, D)).astype(np.float32)
    x_T = rng.standard_normal((B, T, M)).astype(np.float32)
    masks = masks_for([T, 22], T)

    jd = JDiffusion(**cfg)
    params = jax.jit(lambda rngs, f, m: jd.init(rngs, f, m, method=jd.train_step))(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        jnp.asarray(features), jnp.asarray(x_T),
    )["params"]
    params = randomize(params, 3)

    def fixed_normal(key, shape=(), dtype=jnp.float32):
        assert tuple(shape) == x_T.shape, shape
        return jnp.asarray(x_T)

    monkeypatch.setattr(jax.random, "normal", fixed_normal)
    ref = np.asarray(jd.apply(
        {"params": params}, jnp.asarray(features), x_masks=jnp.asarray(masks),
        cond_masks=jnp.asarray(masks), rngs={"diffusion": jax.random.PRNGKey(5)},
    ))

    td = GaussianDiffusion(**cfg)
    td.denoise_fn.load_state_dict(wavenet_from_jax(params["denoise_fn"]))
    with torch.inference_mode():
        got = td(torch.from_numpy(features), x_masks=torch.from_numpy(masks),
                 cond_masks=torch.from_numpy(masks),
                 x_T=torch.from_numpy(x_T)).numpy()
    assert np.isfinite(ref).all() and np.abs(ref - ref.mean()).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-3)
