"""PyTorch port vs the JAX package: the ConvNeXt denoiser. K10's plain
version against the JAX ``DepthwiseConv7`` + ``nn.LayerNorm(1e-6)`` with the
block's pre-add and mask, one denoiser eval with the same weights (carried
across by ``fish_diffusion_tpu_torch.convert``) under both of the JAX
module's dilation modes, and the full UniPC reverse diffusion with the same
x_T.

On the CPU the port runs the plain versions of its kernels (K10, K2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from fish_diffusion_tpu.models.convnext import ConvNext as JConvNext
from fish_diffusion_tpu.models.convnext import DepthwiseConv7
from fish_diffusion_tpu.models.diffusion import GaussianDiffusion as JDiffusion
from fish_diffusion_tpu_torch.convert import convnext_from_jax
from fish_diffusion_tpu_torch.models import convnext
from fish_diffusion_tpu_torch.models.convnext import ConvNext
from fish_diffusion_tpu_torch.models.diffusion import GaussianDiffusion
from tests.test_torch_kernels_cuda import convnext_case
from tests.test_torch_wavenet import masks_for, randomize


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_block_front(args, dilation, static):
    """The JAX ``ConvNeXtBlock`` up to its LayerNorm: the pre-add, the
    mask, ``DepthwiseConv7`` (a traced dilation, or the static switch over
    the cycle's values) and ``nn.LayerNorm(epsilon=1e-6)``."""
    x, step, cond, mask, k, b, ln_scale, ln_bias = (
        None if a is None else jnp.asarray(a.numpy()) for a in args)
    y = x + step[:, None, :] + cond
    if mask is not None:
        y = jnp.where(mask[:, :, None], 0.0, y)
    values = (1, 2, 4, 8) if static else None
    conv = DepthwiseConv7(x.shape[-1], dilation_values=values)
    h = conv.apply({"params": {"kernel": k, "bias": b}}, y,
                   jnp.int32(values.index(dilation) if static else dilation))
    return np.asarray(nn.LayerNorm(epsilon=1e-6).apply(
        {"params": {"scale": ln_scale, "bias": ln_bias}}, h))


@pytest.mark.parametrize("T,masked,zero_bias", [
    (40, False, False), (40, True, False), (5, True, False), (80, True, True),
])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_depthwise_conv7_norm_reference_matches_jax(T, masked, zero_bias, d):
    """K10's plain version against the JAX block's front, both dilation
    modes: <= 1e-5 max abs (outputs of unit scale). T=5 is shorter than the
    halo; with a zero conv bias (as at init) the padded rows whose taps all
    read padding give the ln bias."""
    args = convnext_case(3, T, 32, T + d, masked, zero_bias)
    got = convnext.depthwise_conv7_norm_reference(*args, d).numpy()
    assert np.isfinite(got).all()
    for static in (False, True):
        np.testing.assert_allclose(got, jax_block_front(args, d, static), atol=1e-5)
    if zero_bias:
        mask = args[3].numpy()
        deep = [(b, t) for b in range(3) for t in range(T)
                if all(t + o < 0 or t + o >= T or mask[b, t + o]
                       for o in range(-3 * d, 3 * d + 1, d))]
        assert deep
        for b, t in deep:
            np.testing.assert_array_equal(got[b, t], args[7].numpy())


def test_depthwise_conv7_norm_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is the plain version, bit for bit."""
    args = convnext_case(2, 30, 16, 3, True)
    assert torch.equal(convnext.depthwise_conv7_norm(*args, 2),
                       convnext.depthwise_conv7_norm_reference(*args, 2))


def jax_convnext(static, **cfg):
    return JConvNext(static_dilation_shifts=static, **cfg)


CFG = dict(mel_channels=16, dim=32, mlp_factor=2, num_layers=5, dilation_cycle=4)


@pytest.fixture(scope="module")
def eval_case():
    """Inputs and randomized params of a 5-block ConvNext (dilations 1, 2,
    4, 8, 1) at dim 32, T=48, with padding."""
    rng = np.random.default_rng(0)
    B, T, D = 2, 48, 24
    x = rng.standard_normal((B, T, CFG["mel_channels"])).astype(np.float32)
    t = np.array([500.0, 37.0], np.float32)
    cond = rng.standard_normal((B, T, D)).astype(np.float32)
    masks = masks_for([T, 30], T)
    jnet = jax_convnext(False, condition_dim=D, **CFG)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(cond), jnp.asarray(masks),
                                jnp.asarray(masks))["params"]
    return (x, t, cond, masks), randomize(params, 1), D


@pytest.mark.parametrize("static", [False, True], ids=["traced", "static_shifts"])
def test_convnext_eval_matches_jax(eval_case, static):
    """One denoiser eval, both of the JAX module's dilation modes (the
    parameter tree is the same): <= 1e-4 max abs; the hoisted plan (what
    the sampler uses) gives the same output as the unhoisted call."""
    (x, t, cond, masks), params, D = eval_case
    jnet = jax_convnext(static, condition_dim=D, **CFG)
    ref = np.asarray(jnet.apply({"params": params}, *(jnp.asarray(a) for a in (x, t, cond)),
                                x_masks=jnp.asarray(masks), cond_masks=jnp.asarray(masks)))
    tnet = ConvNext(condition_dim=D, **CFG)
    tnet.load_state_dict(convnext_from_jax(params))
    xt, tt, ct, mt = (torch.from_numpy(a) for a in (x, t, cond, masks))
    with torch.inference_mode():
        got = tnet(xt, tt, ct, x_masks=mt, cond_masks=mt)
        hoisted = tnet(xt, tt, None, x_masks=mt, plan=tnet.prepare(ct, mt))
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    assert torch.equal(got, hoisted)


def test_cross_attention_is_not_ported():
    with pytest.raises(NotImplementedError, match="cross-attention"):
        ConvNext(cross_attention=True)


def test_unipc_sample_matches_jax(monkeypatch):
    """Full UniPC reverse diffusion, 100 evals of a tiny ConvNext, same
    x_T: mel <= 1e-3 max abs (float32 sums taken in another order, through
    100 dependent steps)."""
    rng = np.random.default_rng(2)
    B, T, M, D = 2, 32, 16, 16
    cfg = dict(
        mel_channels=M, timesteps=1000, sampler_interval=10,
        spec_min=[-5], spec_max=[0],
        denoiser=dict(type="ConvNextDenoiser", mel_channels=M, dim=32, mlp_factor=2,
                      condition_dim=D, num_layers=3, dilation_cycle=2),
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
    td.denoise_fn.load_state_dict(convnext_from_jax(params["denoise_fn"]))
    with torch.inference_mode():
        got = td(torch.from_numpy(features), x_masks=torch.from_numpy(masks),
                 cond_masks=torch.from_numpy(masks),
                 x_T=torch.from_numpy(x_T)).numpy()
    assert np.isfinite(ref).all() and np.abs(ref - ref.mean()).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-3)
