"""PyTorch port vs the JAX package: the multi-resolution discriminator (MRD)
of GAN flavor v2 and its 2-D convolutions.

- K6 2-D (``conv2d_nhwc``) against ``blocked_apply_2d`` as
  ``DiscriminatorR`` runs it (4 frequency bins folded into the channels)
  and against the plain ``jax.lax`` conv: the output, and the vjp in the
  input and the taps, at every kernel, stride and padding of the MRD's
  layers, C_in 1 and 32;
- the v2 ``Discriminators`` (MPD + MRD) on the same waveform: scores and
  feature maps (the JAX default, blocked, path against the port's plain
  one), and the gradients of a D loss in the input and every parameter;
- the MRD's gradient stays finite at a silent input (the STFT magnitude's
  eps).

On the CPU the wrappers run their kernels' plain versions. Inputs come from
numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.ops.blocked_conv import (
    blocked_apply_2d,
    conv_triples,
    strided_triples,
)
from fish_diffusion_tpu.training.gan import Discriminators as JDiscriminators
from fish_diffusion_tpu_torch.convert import discriminators_from_jax
from fish_diffusion_tpu_torch.models.discriminators import MultiResolutionDiscriminator
from fish_diffusion_tpu_torch.ops.blocked_conv import conv2d_nhwc
from fish_diffusion_tpu_torch.training.gan import Discriminators

MRD = ((64, 8, 32), (128, 16, 64))
MPD_CFG = dict(periods=(2, 3), channels=(1, 8, 16, 32, 32, 32))


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


# ---------------------------------------------------------------------------
# K6 2-D
# ---------------------------------------------------------------------------


def blocked_layer(x, taps, bias, k, stride, pad, S=4):
    """One MRD layer as ``DiscriminatorR._call_blocked`` runs it: F padded
    to a multiple of S and folded into the channels, the blocked conv, then
    unfolded and cut to the layer's F."""
    b, tt, f, cin = x.shape
    nb = -(-f // S)
    xb = jnp.pad(x, ((0, 0), (0, 0), (0, nb * S - f), (0, 0))).reshape(b, tt, nb, S * cin)
    triples = (conv_triples(k[1], 1, S, pad=pad[1]) if stride[1] == 1
               else strided_triples(k[1], stride[1], pad[1], S))
    yb = blocked_apply_2d(xb, taps, bias, triples, S, S, jnp.float32, (pad[0], pad[0]),
                          stride[1])
    f_out = (f + 2 * pad[1] - k[1]) // stride[1] + 1
    return yb.reshape(b, tt, -1, taps.shape[3])[:, :, :f_out]


def plain_layer(x, taps, bias, k, stride, pad):
    y = jax.lax.conv_general_dilated(
        x, taps, stride, [(pad[0], pad[0]), (pad[1], pad[1])],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST)
    return y + bias


@pytest.mark.parametrize(
    "c_in,c_out,k,stride,pad,F",
    # DiscriminatorR's layers: 0 (C_in 1), 1-3 (stride 2 in F), 4, conv_post
    [(1, 32, (3, 9), (1, 1), (1, 4), 33), (32, 32, (3, 9), (1, 2), (1, 4), 33),
     (32, 32, (3, 9), (1, 2), (1, 4), 16), (32, 32, (3, 3), (1, 1), (1, 1), 9),
     (32, 1, (3, 3), (1, 1), (1, 1), 9)],
)
def test_conv2d_nhwc_matches_blocked_apply_2d(c_in, c_out, k, stride, pad, F):
    """Output and vjp in x and the taps against the blocked and the plain
    JAX conv: <= 1e-4 of each one's max."""
    rng = np.random.default_rng(c_in + c_out + F)
    x = rng.standard_normal((2, 7, F, c_in)).astype(np.float32)
    taps = (rng.standard_normal((*k, c_in, c_out)) * (c_in * k[0] * k[1]) ** -0.5
            ).astype(np.float32)
    bias = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    f_out = (F + 2 * pad[1] - k[1]) // stride[1] + 1
    ct = rng.standard_normal((2, 7, f_out, c_out)).astype(np.float32)

    tx = t(x).requires_grad_()
    tw = t(taps.transpose(3, 2, 0, 1)).requires_grad_()  # torch [C_out, C_in, KH, KW]
    out = conv2d_nhwc(tx, tw, t(bias), stride, pad)
    (out * t(ct)).sum().backward()
    for layer in (blocked_layer, plain_layer):
        ref, vjp = jax.vjp(lambda a, w: layer(a, w, jnp.asarray(bias), k, stride, pad),
                           jnp.asarray(x), jnp.asarray(taps))
        ref_dx, ref_dtaps = vjp(jnp.asarray(ct))
        close(out.detach(), ref, 1e-4, f"{layer.__name__} output")
        close(tx.grad, ref_dx, 1e-4, f"{layer.__name__} dx")
        close(tw.grad.permute(2, 3, 1, 0), ref_dtaps, 1e-4, f"{layer.__name__} dtaps")


# ---------------------------------------------------------------------------
# the v2 discriminators
# ---------------------------------------------------------------------------


def randomize(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + 0.3 * rng.standard_normal(np.shape(a)))
                   + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), tree)


@pytest.fixture(scope="module")
def discs():
    """The JAX v2 discriminators (float32, randomised params) and the
    port's carrying the same weights."""
    jd = JDiscriminators("v2", mpd_cfg=MPD_CFG, mrd_cfg=dict(resolutions=MRD), dtype=None)
    params, spectral = jd.init(jax.random.PRNGKey(5), jnp.zeros((1, 2048)))
    assert spectral == {}
    params = randomize(params, 6)
    td = Discriminators("v2", mpd_cfg=MPD_CFG, mrd_cfg=dict(resolutions=MRD))
    sd, tspec = discriminators_from_jax(params, {}, resolutions=MRD)
    td.load_state_dict(sd)
    assert tspec == {}
    return jd, params, td


def wave(rng, B, T, sr=8000):
    n = np.arange(T) / sr
    y = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 400, (B, 1)) * n)
    return (y + 0.05 * rng.standard_normal((B, T))).astype(np.float32)


def test_v2_discriminators_match_jax(discs):
    """MPD and MRD scores and feature maps: <= 1e-4 of each one's max (the
    JAX MRD runs its blocked path, masked columns and all; the port's plain
    path gives the same maps). The MRD's maps are NHWC in both."""
    jd, params, td = discs
    y = wave(np.random.default_rng(3), 2, 1001)
    (s1, f1), (s2, f2), _ = jd.apply(params, jnp.asarray(y))
    with torch.no_grad():
        (u1, g1), (u2, g2), new = td.apply(t(y))
    assert new == {}
    assert len(u2) == len(s2) == len(MRD)
    for a, b in zip(u1 + u2, s1 + s2):
        close(a, b, 1e-4, "score")
    for maps, ref in zip(g1, f1):
        for a, b in zip(maps, ref):
            close(a.permute(0, 2, 3, 1), b, 1e-4, "mpd fmap")
    for maps, ref in zip(g2, f2):
        assert len(maps) == len(ref) == 6
        for a, b in zip(maps, ref):
            close(a, b, 1e-4, "mrd fmap")


def test_v2_discriminator_gradients_match_jax(discs):
    """d/d(input, params) of the averaged LSGAN D loss on a real and a fake
    waveform (the fake carries the input gradient, as in the G phase):
    K5's backward at n_fft 64/128 with hops that do not divide them, K6
    2-D's input and weight gradients. <= 1e-3 of each tensor's max."""
    from fish_diffusion_tpu.models.discriminators import discriminator_loss as jloss
    from fish_diffusion_tpu_torch.models.discriminators import discriminator_loss

    jd, params, td = discs
    rng = np.random.default_rng(4)
    y, y_hat = wave(rng, 2, 900), wave(rng, 2, 900)

    def loss(p, fake):
        (r1, _), (r2, _), _ = jd.apply(p, jnp.asarray(y))
        (g1, _), (g2, _), _ = jd.apply(p, fake)
        return jloss(r1, g1, average=True) + jloss(r2, g2, average=True)

    ref_p, ref_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(y_hat))
    ref_sd, _ = discriminators_from_jax(jax.tree_util.tree_map(np.asarray, ref_p), {},
                                        resolutions=MRD)
    td.zero_grad()
    fake = t(y_hat).requires_grad_()
    (r1, _), (r2, _), _ = td.apply(t(y))
    (g1, _), (g2, _), _ = td.apply(fake)
    (discriminator_loss(r1, g1, True) + discriminator_loss(r2, g2, True)).backward()
    close(fake.grad, ref_x, 1e-3, "input")
    got = dict(td.named_parameters())
    assert set(got) == set(ref_sd)
    for name, ref in ref_sd.items():
        close(got[name].grad, ref, 1e-3, name)


def test_mrd_gradient_finite_at_a_silent_input():
    """sqrt(re^2 + im^2) has an infinite derivative at a zero bin; the eps
    of 1e-9 keeps the MRD's input gradient finite on digital silence."""
    mrd = MultiResolutionDiscriminator(MRD)
    with torch.no_grad():
        for p in mrd.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    wav = torch.zeros(1, 1024, requires_grad=True)
    scores, _ = mrd(wav)
    sum(torch.mean((s - 1.0) ** 2) for s in scores).backward()
    assert torch.isfinite(wav.grad).all() and wav.grad.shape == (1, 1024)
