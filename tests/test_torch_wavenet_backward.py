"""K1's backward: the port's plain backward of one WaveNet residual block
against ``jax.vjp`` of the JAX package's ``ResidualBlock`` (through flax
``apply``), and the port's ``ResidualBlockFunction`` against torch autograd
of ``residual_block_reference``.

On the CPU the wrappers take the plain versions (``*_reference``,
``conv1d_wgrad_reference``); the card runs the same functions through K1's
backward kernels (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_diffusion_tpu.models.wavenet import ResidualBlock
from fish_diffusion_tpu_torch.models import wavenet
from tests.test_torch_wavenet import randomize


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want))
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize(
    "d,T",
    # T <= 2d: every tap but the centre reads the zero halo
    [(1, 24), (2, 24), (4, 24), (8, 24), (8, 16), (4, 7)],
)
def test_block_backward_matches_jax_vjp(d, T):
    """Every input and weight gradient of one block (R = 64, the conditioner
    already projected) within 1e-5 of its scale: dx, dskip, dcond, the step
    projection's kernel (step_emb^T ds), the three taps and the bias of the
    dilated conv, the output projection's kernel and bias."""
    B, R = 2, 64
    rng = np.random.default_rng(d * 100 + T)
    x, skip = (rng.standard_normal((B, T, R)).astype(np.float32) for _ in range(2))
    cond = rng.standard_normal((B, T, 2 * R)).astype(np.float32)
    step_emb = rng.standard_normal((B, R)).astype(np.float32)
    dx_out, dskip_out = (rng.standard_normal((B, T, R)).astype(np.float32) for _ in range(2))

    block = ResidualBlock(residual_channels=R, use_linear_bias=True, cond_is_projected=True,
                          dilation_values=(d,))
    args = (jnp.asarray(x), jnp.asarray(skip), jnp.asarray(cond), jnp.asarray(step_emb))
    params = block.init(jax.random.PRNGKey(0), (args[0], args[1]), 0, args[2], args[3])
    params = randomize(params["params"], d + T)

    def fn(p, x_, skip_, cond_, step_):
        return block.apply({"params": p}, (x_, skip_), 0, cond_, step_)[0]

    _, vjp = jax.vjp(fn, params, *args)
    gp, gx, gskip, gcond, _ = vjp((jnp.asarray(dx_out), jnp.asarray(dskip_out)))

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    conv, out_p = params["conv_layer"], params["output_projection"]["Dense_0"]
    dp = params["diffusion_projection"]["Dense_0"]
    w_conv = torch.cat([t(conv[k]["kernel"]) for k in ("w_left", "w_center", "w_right")])
    step = t(step_emb) @ t(dp["kernel"]) + t(dp["bias"])
    xs = t(x)
    g, z = wavenet.residual_gate_train_reference(xs, step, t(cond), w_conv, t(conv["bias"]), d)
    dx, dskip, ds, dcond, dw_conv, db_conv, dw_out, db_out = wavenet.residual_block_backward(
        xs, step, z, g, t(dx_out), t(dskip_out), w_conv, t(out_p["kernel"]), d)

    gconv, gout = gp["conv_layer"], gp["output_projection"]["Dense_0"]
    pairs = {
        "dx": (dx, gx), "dskip": (dskip, gskip), "dcond": (dcond, gcond),
        "dW_step": (t(step_emb).t() @ ds, gp["diffusion_projection"]["Dense_0"]["kernel"]),
        "db_step": (ds.sum(0), gp["diffusion_projection"]["Dense_0"]["bias"]),
        "dW_l": (dw_conv[:R], gconv["w_left"]["kernel"]),
        "dW_c": (dw_conv[R : 2 * R], gconv["w_center"]["kernel"]),
        "dW_r": (dw_conv[2 * R :], gconv["w_right"]["kernel"]),
        "db_conv": (db_conv, gconv["bias"]),
        "dW_out": (dw_out, gout["kernel"]), "db_out": (db_out, gout["bias"]),
    }
    for name, (got, want) in pairs.items():
        assert rel_err(got, want) <= 1e-5, (name, rel_err(got, want))


@pytest.mark.parametrize("d,T", [(1, 37), (2, 37), (4, 37), (8, 37), (40, 37)])
def test_block_backward_eight_gradients_match_jax_vjp(d, T):
    """``residual_block_backward``'s eight outputs on the CPU (the plain
    versions, ``residual_weight_grad_reference`` among them) against
    ``jax.vjp`` of the JAX ``ResidualBlock`` at B = 3, R = 128 and T = 37 (d
    = 40 >= T: the outer taps read only zeros), each within 1e-5 of its
    scale: dx, dskip, ds (through the step embedding's gradient, ds W^T),
    dcond, dW_conv (the three taps), db_conv, dW_out, db_out."""
    B, R = 3, 128
    rng = np.random.default_rng(1000 + d)
    x, skip = (rng.standard_normal((B, T, R)).astype(np.float32) for _ in range(2))
    cond = rng.standard_normal((B, T, 2 * R)).astype(np.float32)
    step_emb = rng.standard_normal((B, R)).astype(np.float32)
    dx_out, dskip_out = (rng.standard_normal((B, T, R)).astype(np.float32) for _ in range(2))

    block = ResidualBlock(residual_channels=R, use_linear_bias=True, cond_is_projected=True,
                          dilation_values=(d,))
    args = (jnp.asarray(x), jnp.asarray(skip), jnp.asarray(cond), jnp.asarray(step_emb))
    params = block.init(jax.random.PRNGKey(0), (args[0], args[1]), 0, args[2], args[3])
    params = randomize(params["params"], d + 7)

    def fn(p, x_, skip_, cond_, step_):
        return block.apply({"params": p}, (x_, skip_), 0, cond_, step_)[0]

    _, vjp = jax.vjp(fn, params, *args)
    gp, gx, gskip, gcond, gstep = vjp((jnp.asarray(dx_out), jnp.asarray(dskip_out)))

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    conv, out_p = params["conv_layer"], params["output_projection"]["Dense_0"]
    dp = params["diffusion_projection"]["Dense_0"]
    w_conv = torch.cat([t(conv[k]["kernel"]) for k in ("w_left", "w_center", "w_right")])
    step = t(step_emb) @ t(dp["kernel"]) + t(dp["bias"])
    g, z = wavenet.residual_gate_train_reference(t(x), step, t(cond), w_conv, t(conv["bias"]), d)
    got = wavenet.residual_block_backward(t(x), step, z, g, t(dx_out), t(dskip_out), w_conv,
                                          t(out_p["kernel"]), d)
    gconv, gout = gp["conv_layer"], gp["output_projection"]["Dense_0"]
    want = (gx, gskip, None, gcond,
            np.concatenate([gconv[k]["kernel"] for k in ("w_left", "w_center", "w_right")]),
            gconv["bias"], gout["kernel"], gout["bias"])
    names = ("dx", "dskip", "ds", "dcond", "dW_conv", "db_conv", "dW_out", "db_out")
    for name, got_t, want_t in zip(names, got, want):
        if name == "ds":
            got_t, want_t = got_t @ t(dp["kernel"]).t(), gstep
        assert rel_err(got_t, want_t) <= 1e-5, (name, rel_err(got_t, want_t))


@pytest.mark.parametrize("d,T", [(1, 20), (4, 20), (8, 9)])
def test_autograd_function_matches_plain_autograd(d, T):
    """``ResidualBlockFunction`` (the plain backward functions on the CPU)
    against torch autograd of ``residual_block_reference``: every gradient
    within 1e-5 of its scale."""
    B, R = 2, 64
    gen = torch.Generator().manual_seed(d + T)
    shapes = [(B, T, R), (B, T, R), (B, R), (B, T, 2 * R), (3 * R, 2 * R), (2 * R,),
              (R, 2 * R), (2 * R,)]
    inputs = [torch.randn(s, generator=gen) * (s[0] ** -0.5 if len(s) == 2 and s[0] > B
                                                 else 1.0) for s in shapes]
    dx_out, dskip_out = torch.randn(B, T, R, generator=gen), torch.randn(B, T, R, generator=gen)

    def grads(fn):
        leaves = [a.clone().requires_grad_(True) for a in inputs]
        x_out, skip_out = fn(*leaves, d)
        torch.autograd.backward((x_out, skip_out), (dx_out, dskip_out))
        return (x_out, skip_out), [a.grad for a in leaves]

    outs, got = grads(wavenet.ResidualBlockFunction.apply)
    ref_outs, want = grads(wavenet.residual_block_reference)
    for a, b in zip(outs, ref_outs):
        assert torch.equal(a, b)
    for i, (a, b) in enumerate(zip(got, want)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5, i


def test_denoiser_takes_the_autograd_block_with_grad():
    """``WaveNet.forward`` runs ``residual_block_train`` when grad is
    enabled and ``residual_block`` (serving) when it is not."""
    net = wavenet.WaveNet(mel_channels=16, d_encoder=8, residual_channels=64,
                          residual_layers=2, use_linear_bias=True, dilation_cycle=2)
    x, t, c = torch.randn(1, 12, 16), torch.tensor([3.0]), torch.randn(1, 12, 8)
    calls = []
    real = {name: getattr(wavenet, name) for name in ("residual_block", "residual_block_train")}

    def spy(name):
        def call(*args):
            calls.append(name)
            return real[name](*args)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for name in real:
            mp.setattr(wavenet, name, spy(name))
        trained = net(x, t, c)
        with torch.no_grad():
            served = net(x, t, c)
    assert calls == ["residual_block_train"] * 2 + ["residual_block"] * 2
    assert torch.allclose(trained, served, atol=1e-6)


def test_prepare_splits_the_live_weights_after_an_optimizer_step():
    """``prepare`` splits each block's packed weights for the float32
    kernels (``tf32_split``) from the live parameters on every call, with no
    gradient through the split: after an optimizer step the next plan
    carries the new weights' split, and the forward under grad still gives
    the packed weights' parameters their gradients. Under grad it also
    splits W_out as stored for the gate backward (``bwd_split``); without
    grad it does not."""
    torch.manual_seed(15)
    net = wavenet.WaveNet(mel_channels=16, d_encoder=8, residual_channels=64,
                          residual_layers=2, use_linear_bias=True, dilation_cycle=2)
    x, t, c = torch.randn(2, 12, 16), torch.tensor([3.0, 40.0]), torch.randn(2, 12, 8)
    opt = torch.optim.SGD(net.parameters(), lr=0.5)
    before = net.prepare(c)
    for w, split in zip(before["w_conv"] + before["w_out"],
                        before["conv_split"] + before["out_split"]):
        assert torch.equal(split, wavenet.tf32_split(w))
        assert not split.requires_grad and split.grad_fn is None
    for w, split in zip(before["w_out"], before["bwd_split"]):
        assert torch.equal(split, wavenet.tf32_split(w.t()))
        assert not split.requires_grad and split.grad_fn is None
    with torch.no_grad():
        assert net.prepare(c)["bwd_split"] == [None, None]
    net(x, t, c).square().mean().backward()
    layer = net.residual_layers[0]
    assert layer.conv_layer.conv.weight.grad.abs().sum() > 0
    assert layer.output_projection.conv.weight.grad.abs().sum() > 0
    opt.step()
    after = net.prepare(c)
    for i, layer in enumerate(net.residual_layers):
        w_conv = layer.conv_layer.conv.weight.detach().permute(2, 1, 0).reshape(128 * 3 // 2, 128)
        assert torch.equal(after["conv_split"][i], wavenet.tf32_split(w_conv))
        assert not torch.equal(after["conv_split"][i], before["conv_split"][i])
        w_out = layer.output_projection.conv.weight.detach()[:, :, 0].t()
        assert torch.equal(after["out_split"][i], wavenet.tf32_split(w_out))
        assert not torch.equal(after["out_split"][i], before["out_split"][i])
        assert torch.equal(after["bwd_split"][i], wavenet.tf32_split(w_out.t()))
        assert not torch.equal(after["bwd_split"][i], before["bwd_split"][i])
