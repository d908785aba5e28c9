"""PyTorch port vs the JAX package: the gradient of ``repeat_expand`` in
linear mode (RefineGAN's resampling, ``linear_resize``).

The port's forward is ``F.interpolate``; its backward is a gather in the
source's order over a fixed table (``ops/tensor.py:_LinearResample``), so
that a rerun on the card gives the same bits. Here it is held against
``jax.vjp`` of the JAX function and against torch autograd of
``F.interpolate`` on the CPU, within 1e-6 of the gradient's scale: up and
down at rates 2 and 8, ratios that are not integers, and sources of one
and two rows (where the edge clamp sends most outputs to row 0). Inputs
come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fish_diffusion_tpu.ops.tensor import repeat_expand as jrepeat_expand
from fish_diffusion_tpu_torch.models.vocoders.refinegan import linear_resize
from fish_diffusion_tpu_torch.ops.tensor import linear_gather_table, repeat_expand

CASES = [(24, 48), (48, 24), (16, 128), (128, 16), (30, 7), (7, 30), (33, 50), (1, 8),
         (2, 16), (1, 3), (2, 1)]


def close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), max(np.abs(ref).max(), 1e-30)
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


def case(src, dst):
    rng = np.random.default_rng(src * 1000 + dst)
    x = rng.standard_normal((2, 3, src)).astype(np.float32)
    g = rng.standard_normal((2, 3, dst)).astype(np.float32)
    return x, g


def port_grad(x, g, dst):
    xt = torch.from_numpy(x).requires_grad_(True)
    repeat_expand(xt, dst).backward(torch.from_numpy(g))
    return xt.grad


@pytest.mark.parametrize("src,dst", CASES)
def test_linear_backward_matches_jax_vjp(src, dst):
    """The gather against ``jax.vjp`` of the JAX ``repeat_expand`` (its
    integer-upsampling path included): <= 1e-6 of scale."""
    x, g = case(src, dst)
    _, vjp = jax.vjp(lambda a: jrepeat_expand(a, dst, "linear"), jnp.asarray(x))
    close(port_grad(x, g, dst), vjp(jnp.asarray(g))[0], 1e-6, f"{src}->{dst}")


@pytest.mark.parametrize("src,dst", CASES)
def test_linear_backward_matches_interpolate_autograd(src, dst):
    """The gather against torch autograd of ``F.interpolate`` (CPU): <=
    1e-6 of scale; the forward is ``F.interpolate``'s, bit for bit; a
    second backward gives the same bits."""
    x, g = case(src, dst)
    xt = torch.from_numpy(x).requires_grad_(True)
    ref_out = F.interpolate(xt, size=dst, mode="linear", align_corners=False)
    ref_out.backward(torch.from_numpy(g))
    got = port_grad(x, g, dst)
    close(got, xt.grad, 1e-6, f"{src}->{dst}")
    assert torch.equal(repeat_expand(torch.from_numpy(x), dst), ref_out.detach())
    assert torch.equal(got, port_grad(x, g, dst))


def test_gather_table_holds_every_tap_once():
    """Each output's two taps appear once in the table, with weights that
    sum to 1 per output; the padding has weight 0. At upsampling rate 8 the
    edge clamp puts the first outputs on row 0 alone."""
    for src, dst in CASES:
        index, weight = linear_gather_table(src, dst)
        assert index.shape[0] == src and weight.dtype == np.float32
        per_out = np.zeros(dst, np.float64)
        np.add.at(per_out, index.ravel(), weight.ravel().astype(np.float64))
        np.testing.assert_allclose(per_out, 1.0, atol=1e-6)
        assert (weight >= 0).all()
    index, weight = linear_gather_table(16, 128)
    assert weight.shape[1] >= 8 + 4  # row 0: its own 8 taps and the 4 clamped outputs


def test_linear_resize_layout_gradient():
    """``linear_resize`` ([B, T, C]) differentiates through the gather:
    equal to autograd of ``F.interpolate`` on the transposed layout."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 40, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 320, 6)).astype(np.float32))
    a = x.clone().requires_grad_(True)
    linear_resize(a, 320).backward(g)
    b = x.clone().requires_grad_(True)
    F.interpolate(b.transpose(1, 2), size=320, mode="linear",
                  align_corners=False).transpose(1, 2).backward(g)
    close(a.grad, b.grad, 1e-6, "linear_resize")
