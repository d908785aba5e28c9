"""PyTorch port vs the JAX package: the NSF harmonic source (the
``BlockedSourceModule`` signal) and the NSF-HiFiGAN generator, with the same
weights and the same injected random draws.

On the CPU the port runs the plain versions of its kernels (K3, K4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.models.vocoders.nsf_hifigan import (
    NsfHifiGANGenerator as JGenerator,
)
from fish_diffusion_tpu.models.vocoders.source import BlockedSourceModule
from fish_diffusion_tpu_torch.convert import nsf_hifigan_from_jax
from fish_diffusion_tpu_torch.models.vocoders.nsf_hifigan import NsfHifiGANGenerator
from fish_diffusion_tpu_torch.models.vocoders.source import nsf_source

SR = 44100


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(tree, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    new = []
    for x in leaves:
        shape = np.shape(x)
        fan_in = int(np.prod(shape[:-1])) if len(shape) >= 2 else 0
        scale = fan_in ** -0.5 if fan_in else 0.1
        new.append((rng.standard_normal(shape) * scale).astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, new)


def draws(rng, B, T, hop, dim=9):
    """The source's random inputs, and a stand-in for ``jax.random`` that
    hands the same arrays to the JAX modules by shape."""
    rand_ini = rng.uniform(size=(B, dim)).astype(np.float32)
    rand_ini[:, 0] = 0.0
    noise = rng.standard_normal((B, T, hop, dim)).astype(np.float32)
    extra = rng.standard_normal((B, T * hop, 1)).astype(np.float32)
    by_shape = {(B, dim): rand_ini, (B, T, hop, dim): noise, (B, T * hop, 1): extra}

    def lookup(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        return jnp.asarray(by_shape[tuple(shape)])

    port = (torch.from_numpy(rand_ini), torch.from_numpy(noise.reshape(B, T * hop, dim)))
    return lookup, port


def f0_curve(rng, B, T):
    f0 = rng.uniform(90, 600, (B, T)).astype(np.float32)
    f0[rng.random((B, T)) < 0.25] = 0.0
    return f0


@pytest.mark.parametrize("T,hop", [(16, 64), (200, 512)])
def test_nsf_source_matches_blocked_source_module(monkeypatch, T, hop):
    """Merged harmonic source with injected rand_ini and noise: <= 1e-4.
    T=200 at hop 512 checks the phase carried across 100k samples."""
    rng = np.random.default_rng(T)
    B = 2
    f0 = f0_curve(rng, B, T)
    lookup, (rand_ini, noise) = draws(rng, B, T, hop)

    module = BlockedSourceModule(sampling_rate=SR, hop=hop, harmonic_num=8,
                                 interp="nearest")
    params = randomize(jax.jit(module.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(f0),
    )["params"], 1)
    monkeypatch.setattr(jax.random, "uniform", lookup)
    monkeypatch.setattr(jax.random, "normal", lookup)
    # traced under the patch: the injected draws become constants
    ref, _, _ = jax.jit(module.apply)({"params": params}, jnp.asarray(f0),
                                      rngs={"noise": jax.random.PRNGKey(2)})

    lin = params["l_linear"]
    got = nsf_source(torch.from_numpy(f0), rand_ini, noise,
                     torch.from_numpy(lin["kernel"][:, 0].copy()),
                     torch.from_numpy(lin["bias"]), SR, hop)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_nsf_generator_matches_jax(monkeypatch):
    """Generator at upsample_rates=(2, 2, 2), upsample_initial_channel=32,
    two resblock fans, T=32 frames, same weights and draws: <= 1e-4."""
    rng = np.random.default_rng(7)
    B, T, M = 2, 32, 128
    gen_cfg = dict(num_mels=M, sampling_rate=SR, hop_size=8,
                   upsample_rates=(2, 2, 2), upsample_kernel_sizes=(4, 4, 4),
                   upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
                   resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
    mel = (rng.standard_normal((B, T, M)) * 0.5 - 2).astype(np.float32)
    f0 = f0_curve(rng, B, T)
    lookup, (rand_ini, noise) = draws(rng, B, T, 8)

    jgen = JGenerator(**gen_cfg)
    params = jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(mel), jnp.asarray(f0),
    )["params"]
    params = randomize(params, 2)
    monkeypatch.setattr(jax.random, "uniform", lookup)
    monkeypatch.setattr(jax.random, "normal", lookup)
    ref = np.asarray(jax.jit(jgen.apply)(
        {"params": params}, jnp.asarray(mel), jnp.asarray(f0),
        rngs={"noise": jax.random.PRNGKey(3)},
    ))

    tgen = NsfHifiGANGenerator(**gen_cfg)
    tgen.load_state_dict(nsf_hifigan_from_jax(params))
    with torch.inference_mode():
        got = tgen(torch.from_numpy(mel), torch.from_numpy(f0), rand_ini, noise).numpy()
    assert got.shape == (B, T * 8) and np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got, ref, atol=1e-4)
