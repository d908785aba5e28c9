"""PyTorch port vs the JAX package: the pieces of the v1 GAN step.

- K6 (``grouped_conv1d``) against ``blocked_apply_grouped``: output and the
  vjp in x and the taps;
- the NSF-HiFiGAN generator's parameter gradients (K4's input and weight
  gradients, K3's backward) against ``jax.grad``;
- the MPD and MSD after one discriminator-phase pass (scores, feature maps,
  spectral-norm u/v), with the weights carried across by
  ``convert.discriminators_from_jax``;
- every loss.

On the CPU the port's wrappers run their kernels' plain versions. Inputs
come from numpy with a seed; the generator's random draws are injected by
shape, as in ``tests/test_torch_vocoder.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.models import discriminators as jdisc
from fish_diffusion_tpu.models.vocoders.nsf_hifigan import (
    NsfHifiGANGenerator as JGenerator,
)
from fish_diffusion_tpu.ops.blocked_conv import blocked_apply_grouped
from fish_diffusion_tpu.training.gan import Discriminators as JDiscriminators
from fish_diffusion_tpu_torch.convert import discriminators_from_jax, nsf_hifigan_from_jax
from fish_diffusion_tpu_torch.models import discriminators as tdisc
from fish_diffusion_tpu_torch.models.vocoders.nsf_hifigan import NsfHifiGANGenerator
from fish_diffusion_tpu_torch.ops.blocked_conv import grouped_conv1d
from fish_diffusion_tpu_torch.training.gan import Discriminators

SR = 44100
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
# K6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "layer,c_in,c_out,stride,groups,s_in,T",
    # the MSD's K6 layers 1, 2 and 5 at their widths, a few dozen samples
    [(1, 128, 128, 2, 4, 4, 50), (2, 128, 256, 2, 16, 8, 37), (5, 1024, 1024, 1, 16, 2, 13)],
)
def test_grouped_conv1d_matches_blocked_apply_grouped(layer, c_in, c_out, stride,
                                                      groups, s_in, T):
    """Output and vjp in x and the taps: <= 1e-4 of each one's max."""
    rng = np.random.default_rng(layer)
    K = 41
    x = rng.standard_normal((2, T, c_in)).astype(np.float32)
    taps = (rng.standard_normal((K, c_in // groups, c_out)) * (K * c_in / groups) ** -0.5
            ).astype(np.float32)
    bias = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    t_out = (T - 1) // stride + 1
    ct = rng.standard_normal((2, t_out, c_out)).astype(np.float32)

    def jax_layer(x, taps):  # as DiscriminatorS runs it
        rem = (-x.shape[1]) % s_in
        xp = jnp.pad(x, ((0, 0), (0, rem), (0, 0)))
        return blocked_apply_grouped(xp, taps, jnp.asarray(bias), K, stride, groups,
                                     s_in, jnp.float32)[:, :t_out]

    ref, vjp = jax.vjp(jax_layer, jnp.asarray(x), jnp.asarray(taps))
    ref_dx, ref_dtaps = vjp(jnp.asarray(ct))

    tx = t(x).requires_grad_()
    tw = t(taps.transpose(2, 1, 0)).requires_grad_()  # torch [C_out, C_in / g, K]
    out = grouped_conv1d(tx, tw, t(bias), stride, groups)
    (out * t(ct)).sum().backward()
    close(out.detach(), ref, 1e-4, "output")
    close(tx.grad, ref_dx, 1e-4, "dx")
    close(tw.grad.permute(2, 1, 0), ref_dtaps, 1e-4, "dtaps")


# ---------------------------------------------------------------------------
# the generator's gradients
# ---------------------------------------------------------------------------


def randomize(tree, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    new = []
    for x in leaves:
        shape = np.shape(x)
        fan_in = int(np.prod(shape[:-1])) if len(shape) >= 2 else 0
        new.append((rng.standard_normal(shape) * (fan_in ** -0.5 if fan_in else 0.1)
                    ).astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, new)


def injected_draws(rng, B, T, hop, dim=9):
    """The source's draws, and a stand-in for ``jax.random`` that hands the
    same arrays to the JAX modules by shape."""
    rand_ini = rng.uniform(size=(B, dim)).astype(np.float32)
    rand_ini[:, 0] = 0.0
    noise = rng.standard_normal((B, T, hop, dim)).astype(np.float32)
    extra = rng.standard_normal((B, T * hop, 1)).astype(np.float32)
    by_shape = {(B, dim): rand_ini, (B, T, hop, dim): noise, (B, T * hop, 1): extra}

    def lookup(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        return jnp.asarray(by_shape[tuple(shape)])

    return lookup, (t(rand_ini), t(noise.reshape(B, T * hop, dim)))


def test_generator_gradients_match_jax_grad(monkeypatch):
    """d/dparams of sum(y_hat * r) for every generator parameter, through
    K4's input and weight gradients and K3's backward (``l_linear``):
    <= 1e-3 of each tensor's largest gradient."""
    rng = np.random.default_rng(11)
    B, T, M, hop = 2, 24, 16, 8
    gen_cfg = dict(num_mels=M, sampling_rate=SR, hop_size=hop, upsample_rates=(2, 2, 2),
                   upsample_kernel_sizes=(4, 4, 4), upsample_initial_channel=32,
                   resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
    mel = (rng.standard_normal((B, T, M)) * 0.5 - 2).astype(np.float32)
    f0 = rng.uniform(90, 600, (B, T)).astype(np.float32)
    f0[rng.random((B, T)) < 0.25] = 0.0
    r = rng.standard_normal((B, T * hop)).astype(np.float32)

    jgen = JGenerator(**gen_cfg)
    params = randomize(jax.jit(jgen.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(mel), jnp.asarray(f0))["params"], 2)
    lookup, (rand_ini, noise) = injected_draws(rng, B, T, hop)
    monkeypatch.setattr(jax.random, "uniform", lookup)
    monkeypatch.setattr(jax.random, "normal", lookup)

    def loss(p):
        y = jgen.apply({"params": p}, jnp.asarray(mel), jnp.asarray(f0),
                       rngs={"noise": jax.random.PRNGKey(3)})
        return jnp.sum(y * jnp.asarray(r))

    ref = nsf_hifigan_from_jax(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)))

    tgen = NsfHifiGANGenerator(**gen_cfg)
    tgen.load_state_dict(nsf_hifigan_from_jax(params))
    (tgen(t(mel), t(f0), rand_ini, noise) * t(r)).sum().backward()
    got = {name: p.grad for name, p in tgen.named_parameters()}
    assert set(got) == set(ref)
    for name in ref:
        close(got[name], ref[name], 1e-3, name)
    assert got["m_source.l_linear.weight"].abs().max() > 0


# ---------------------------------------------------------------------------
# the discriminators
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def discs():
    """The JAX v1 discriminators (float32) with their initial params and
    spectral state, and the port's carrying the same weights."""
    jd = JDiscriminators("v1", mpd_cfg=MPD_CFG, dtype=None)
    params, spectral = jd.init(jax.random.PRNGKey(5), jnp.zeros((1, 2048)))
    params = jax.tree_util.tree_map(np.asarray, params)
    spectral = jax.tree_util.tree_map(np.asarray, spectral)
    td = Discriminators(mpd_cfg=MPD_CFG)
    sd, tspec = discriminators_from_jax(params, spectral)
    td.load_state_dict(sd)
    return jd, params, spectral, td, tspec


def wave(rng, B, T):
    n = np.arange(T) / SR
    y = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 400, (B, 1)) * n)
    return (y + 0.05 * rng.standard_normal((B, T))).astype(np.float32)


def test_discriminators_one_update_match_jax(discs):
    """One discriminator-phase pass (``update=True``): MPD and MSD scores,
    feature maps and the spectral u/v it returns: <= 1e-4 of each one's
    max. The MPD's maps are NCHW in the port, NHWC in JAX."""
    jd, params, spectral, td, tspec = discs
    y = wave(np.random.default_rng(3), 2, 3001)  # odd: the MPD pads by reflection
    (s1, f1), (s2, f2), jspec = jd.apply(params, jnp.asarray(y), spectral, update=True)
    with torch.no_grad():
        (u1, g1), (u2, g2), new = td.apply(t(y), tspec, update=True)
    for a, b in zip(u1 + u2, s1 + s2):
        close(a, b, 1e-4, "score")
    for maps, ref in zip(g1, f1):
        for a, b in zip(maps, ref):
            close(a.permute(0, 2, 3, 1), b, 1e-4, "mpd fmap")
    for maps, ref in zip(g2, f2):
        for a, b in zip(maps, ref):
            close(a, b, 1e-4, "msd fmap")
    _, jnew = discriminators_from_jax(params, jax.tree_util.tree_map(np.asarray, jspec))
    assert set(new) == set(jnew) == set(tspec) and len(new) == 16
    for k in jnew:
        close(new[k], jnew[k], 1e-4, k)
        if new[k].numel() > 1:  # conv_post's u has one entry: +-1 throughout
            assert not torch.equal(new[k], tspec[k]), f"{k} did not advance"


def test_spectral_state_unchanged_without_update(discs):
    """``update=False`` (the generator phase) uses u/v as they are and
    returns them unchanged."""
    _, _, _, td, tspec = discs
    with torch.no_grad():
        *_, new = td.apply(t(wave(np.random.default_rng(4), 1, 2048)), tspec)
    for k, v in tspec.items():
        assert torch.equal(new[k], v)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------


def test_losses_match_jax():
    """Every loss of the v1 step on the same inputs: <= 1e-4 relative."""
    rng = np.random.default_rng(9)
    y, y_hat = wave(rng, 2, 8192), wave(rng, 2, 8192)
    real = [rng.standard_normal((2, n)).astype(np.float32) for n in (40, 17)]
    fake = [rng.standard_normal((2, n)).astype(np.float32) for n in (40, 17)]
    fr = [[rng.standard_normal((2, 9, 4)).astype(np.float32) for _ in range(2)]]
    fg = [[rng.standard_normal((2, 9, 4)).astype(np.float32) for _ in range(2)]]
    J = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    T = lambda xs: [t(x) for x in xs]  # noqa: E731
    scales = ((1024, 256, 1024), (1024, 270, 540))
    pairs = [
        (jdisc.discriminator_loss(J(real), J(fake)), tdisc.discriminator_loss(T(real), T(fake))),
        (jdisc.discriminator_loss(J(real), J(fake), average=True),
         tdisc.discriminator_loss(T(real), T(fake), average=True)),
        (jdisc.generator_adv_loss(J(fake)), tdisc.generator_adv_loss(T(fake))),
        (jdisc.feature_loss([J(m) for m in fr], [J(m) for m in fg]),
         tdisc.feature_loss([T(m) for m in fr], [T(m) for m in fg])),
        (jdisc.envelope_loss(jnp.asarray(y), jnp.asarray(y_hat)),
         tdisc.envelope_loss(t(y), t(y_hat))),
        (jdisc.multi_scale_mel_loss(jnp.asarray(y), jnp.asarray(y_hat), SR, scales, loss="l1"),
         tdisc.multi_scale_mel_loss(t(y), t(y_hat), SR, scales, loss="l1")),
        (jdisc.multi_scale_mel_loss(jnp.asarray(y), jnp.asarray(y_hat), SR, scales),
         tdisc.multi_scale_mel_loss(t(y), t(y_hat), SR, scales)),
        (jdisc.multi_scale_stft_loss(jnp.asarray(y), jnp.asarray(y_hat)),
         tdisc.multi_scale_stft_loss(t(y), t(y_hat))),
    ]
    for i, (ref, got) in enumerate(pairs):
        close(float(got), float(ref), 1e-4, f"loss {i}")
