"""K10's backward: the port's plain backward of the ConvNeXt block's front
(the pre-add, the padding mask, the dilated depthwise conv7 and the
LayerNorm that K10 fuses) against ``jax.vjp`` of the JAX package's
``DepthwiseConv7`` + ``nn.LayerNorm(epsilon=1e-6)`` with the block's
pre-add and mask (the training lowering: static dilation shifts), and the
port's ``DepthwiseConv7NormFunction`` against torch autograd of
``depthwise_conv7_norm_reference``.

On the CPU the wrappers take the plain versions (``*_reference``); the
card runs the same functions through K10's backward kernels
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``) and the host
emulation runs their CUDA source (``tests/test_torch_csrc_emulated.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from fish_diffusion_tpu.models.convnext import DepthwiseConv7
from fish_diffusion_tpu_torch.models import convnext
from tests.test_torch_kernels_cuda import convnext_case

DILATIONS = (1, 2, 4, 8)
NAMES = ("dx", "dstep", "dcond", "dk", "db", "dln_scale", "dln_bias")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def go_for(shape, seed):
    """dL/dout from a seeded numpy draw, nonzero at padded rows too (the
    kernels compute the general function)."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def jax_front_vjp(args, go, d):
    """``jax.vjp`` of the JAX block's front at dilation d (the static
    switch over the cycle's dilations, as ``build_model(training=True)``
    lowers it) -> the gradients of (x, step, cond, k, b, ln_scale, ln_bias)."""
    x, step, cond, mask, k, b, ln_scale, ln_bias = (
        None if a is None else jnp.asarray(a.numpy()) for a in args)
    conv = DepthwiseConv7(x.shape[-1], dilation_values=DILATIONS)
    norm = nn.LayerNorm(epsilon=1e-6)

    def front(x_, step_, cond_, k_, b_, scale_, bias_):
        y = x_ + step_[:, None, :] + cond_
        if mask is not None:
            y = jnp.where(mask[:, :, None], 0.0, y)
        h = conv.apply({"params": {"kernel": k_, "bias": b_}}, y,
                       jnp.int32(DILATIONS.index(d)))
        return norm.apply({"params": {"scale": scale_, "bias": bias_}}, h)

    _, vjp = jax.vjp(front, x, step, cond, k, b, ln_scale, ln_bias)
    gx, gstep, gcond, gk, gb, gscale, gbias = vjp(jnp.asarray(go.numpy()))
    return {"dx": gx, "dstep": gstep, "dcond": gcond, "dk": gk, "db": gb,
            "dln_scale": gscale, "dln_bias": gbias}


def rel_l2(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want, np.float32))
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("T,masked,zero_bias", [
    (40, False, False),  # unmasked
    (40, True, False),   # padded items
    (5, True, False),    # T shorter than the halo at every dilation
    (80, True, True),    # zero conv bias: padded rows of variance 0 (r = 1000)
])
@pytest.mark.parametrize("d", DILATIONS)
def test_backward_reference_matches_jax_vjp(T, masked, zero_bias, d):
    """Every gradient of the front (B=3, C=32), the padded rows' go
    nonzero: within 1e-5 relative L2 of ``jax.vjp``, the rows of variance 0
    (r = 1 / sqrt(1e-6) = 1000, the zero-bias cases) included: their h is 0
    exactly in both, so r scales no rounding (3.2e-7 at most over the cases
    on the CPU)."""
    args = convnext_case(3, T, 32, 10 * T + d, masked, zero_bias)
    go = go_for((3, T, 32), T + d)
    got = convnext.depthwise_conv7_norm_backward_reference(go, *args, d)
    want = jax_front_vjp(args, go, d)
    for name, g in zip(NAMES, got):
        assert torch.isfinite(g).all(), name
        assert rel_l2(g, want[name]) <= 1e-5, (name, rel_l2(g, want[name]))
    if masked:
        # the mask zeroes the gradient of the padded source rows only
        mask = args[3]
        assert (got[0][mask] == 0).all()
        assert (got[0][~mask] != 0).any()


def test_zero_variance_rows_are_exercised():
    """The zero-bias case above holds rows of variance 0 (every tap in
    padding: h = 0 exactly) whose dh is nonzero only through their go."""
    d, T = 4, 80
    args = convnext_case(3, T, 32, 10 * T + d, True, True)
    x, step, cond, mask, k, b, *_ = args
    h = convnext._conv7(convnext._pre_add(x, step, cond, mask), k, b, d)
    flat = (h == 0).all(-1)
    assert flat.any()
    go = go_for((3, T, 32), T + d)
    dh = convnext.depthwise_conv7_norm_backward_rows_reference(go, *args[:-1], d)[0]
    assert torch.isfinite(dh).all() and (dh[flat].abs() > 1.0).any()


def leaves_of(args):
    x, step, cond, mask, k, b, ln_scale, ln_bias = args
    return [t.clone().requires_grad_(True) for t in (x, step, cond, k, b, ln_scale, ln_bias)], \
        mask


@pytest.mark.parametrize("d,T", [(1, 24), (4, 24), (8, 9)])
def test_autograd_function_matches_plain_autograd(d, T):
    """``DepthwiseConv7NormFunction`` (the plain versions on the CPU)
    against torch autograd of ``depthwise_conv7_norm_reference``: the
    output equal, every gradient within 1e-5 relative L2."""
    args = convnext_case(2, T, 48, d + T, True)
    go = go_for((2, T, 48), d)

    def grads(fn):
        (x, step, cond, k, b, w, lb), mask = leaves_of(args)
        out = fn(x, step, cond, mask, k, b, w, lb, d)
        out.backward(go)
        return out.detach(), [t.grad for t in (x, step, cond, k, b, w, lb)]

    out, got = grads(convnext.DepthwiseConv7NormFunction.apply)
    ref_out, want = grads(convnext.depthwise_conv7_norm_reference)
    assert torch.equal(out, ref_out)
    for name, a, b in zip(NAMES, got, want):
        assert float((a - b).norm() / b.norm()) <= 1e-5, name


def test_one_tensor_for_x_and_cond_gives_each_its_gradient():
    """The backward returns one tensor as the gradient of x and of cond.
    x has a second use (the block's residual), so its gradient accumulates
    a second term; cond's must stay the pre-add's gradient alone, and both
    must equal plain autograd's."""
    d, T = 2, 30
    args = convnext_case(2, T, 16, 7, True)
    go = go_for((2, T, 16), 1)
    other = go_for((2, T, 16), 2)

    def grads(fn):
        (x, step, cond, k, b, w, lb), mask = leaves_of(args)
        out = fn(x, step, cond, mask, k, b, w, lb, d)
        ((out * go).sum() + (x * other).sum()).backward()
        return x.grad, cond.grad

    gx, gcond = grads(convnext.DepthwiseConv7NormFunction.apply)
    rx, rcond = grads(convnext.depthwise_conv7_norm_reference)
    assert gx.data_ptr() != gcond.data_ptr()
    torch.testing.assert_close(gcond, rcond, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx, rx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx - gcond, other, rtol=1e-5, atol=1e-6)


def test_wrapper_takes_the_function_only_under_grad():
    """``depthwise_conv7_norm`` goes through the Function when grad is on
    and an input requires it, and is the plain version (bit for bit) on CPU
    tensors otherwise."""
    args = convnext_case(2, 20, 16, 4, True)
    calls = []
    real = convnext.DepthwiseConv7NormFunction.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convnext.DepthwiseConv7NormFunction, "apply",
                   lambda *a: calls.append(1) or real(*a))
        plain = convnext.depthwise_conv7_norm(*args, 2)
        k = args[4].clone().requires_grad_(True)
        trained = convnext.depthwise_conv7_norm(*args[:4], k, *args[5:], 2)
        with torch.no_grad():
            convnext.depthwise_conv7_norm(*args[:4], k, *args[5:], 2)
    assert calls == [1]
    assert trained.requires_grad and torch.equal(trained.detach(), plain)
    assert torch.equal(plain, convnext.depthwise_conv7_norm_reference(*args, 2))


def test_denoiser_takes_the_function_with_grad():
    """``ConvNext.forward`` runs every block through
    ``DepthwiseConv7NormFunction`` (and its backward through
    ``depthwise_conv7_norm_backward``) when grad is enabled, and the
    serving kernel when it is not; both give the same output, and every
    parameter gets a gradient."""
    net = convnext.ConvNext(mel_channels=16, dim=32, mlp_factor=2, condition_dim=8,
                            num_layers=3, dilation_cycle=2)
    for p in net.parameters():  # gamma 1e-6 would hide the blocks
        torch.nn.init.normal_(p, std=0.3, generator=torch.Generator().manual_seed(p.numel()))
    x, t, c = torch.randn(2, 12, 16), torch.tensor([3.0, 500.0]), torch.randn(2, 12, 8)
    masks = torch.arange(12)[None, :] >= torch.tensor([12, 7])[:, None]
    calls = []
    real_apply = convnext.DepthwiseConv7NormFunction.apply
    real_backward = convnext.depthwise_conv7_norm_backward

    def backward(*args):
        calls.append("backward")
        return real_backward(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convnext.DepthwiseConv7NormFunction, "apply",
                   lambda *a: calls.append("function") or real_apply(*a))
        mp.setattr(convnext, "depthwise_conv7_norm_backward", backward)
        trained = net(x, t, c, x_masks=masks, cond_masks=masks)
        trained.square().sum().backward()
        with torch.no_grad():
            served = net(x, t, c, x_masks=masks, cond_masks=masks)
    assert calls == ["function"] * 3 + ["backward"] * 3
    torch.testing.assert_close(trained.detach(), served, rtol=0, atol=1e-6)
    for name, p in net.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
