"""The port's hand-written kernels (K1 with its training mode, backward and
weight split,
K2-K6 with K6 2-D and K5 istft, K7,
K8-cand, K8 dense, K9 comb and sine, K10 with its backward, the weight gradients, and the
backward kernels of K3 and K5) against their plain PyTorch versions
on an NVIDIA GPU, at small shapes that exercise the ragged edges.

These need the card (the CUDA kernels have no CPU mode, and Triton needs a
GPU); without one they skip. On the card:
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
The full-width check of every kernel is ``chip_smoke.py``."""

import math

import numpy as np
import pytest
import torch

from fish_diffusion_tpu_torch import kernels
from fish_diffusion_tpu_torch.extractors import crepe, pitch
from fish_diffusion_tpu_torch.models import convnext, diffusion, wavenet
from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, source
from fish_diffusion_tpu_torch.ops import blocked_conv, mel
from fish_diffusion_tpu_torch.ops import monotonic_align as ma

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def rn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


@pytest.mark.parametrize("B,T,R,d", [(2, 70, 64, 1), (1, 130, 128, 8), (3, 17, 64, 4)])
def test_residual_block(gen, B, T, R, d):
    """K1 f32: <= 1e-4 (sums of 3R products in another order)."""
    x, skip, step, cond = rn(gen, B, T, R), rn(gen, B, T, R), rn(gen, B, R), rn(gen, B, T, 2 * R)
    w_conv, b_conv = rn(gen, 3 * R, 2 * R, scale=(3 * R) ** -0.5), rn(gen, 2 * R)
    w_out, b_out = rn(gen, R, 2 * R, scale=R ** -0.5), rn(gen, 2 * R)
    args = (x, skip, step, cond, w_conv, b_conv, w_out, b_out, d)
    got = wavenet.residual_block(*args)
    ref = wavenet.residual_block_reference(*args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=0)


def k1_training_inputs(gen, B, T, R):
    return dict(x=rn(gen, B, T, R), skip=rn(gen, B, T, R), step=rn(gen, B, R),
                cond=rn(gen, B, T, 2 * R), w_conv=rn(gen, 3 * R, 2 * R, scale=(3 * R) ** -0.5),
                b_conv=rn(gen, 2 * R, scale=0.1), w_out=rn(gen, R, 2 * R, scale=R ** -0.5),
                b_out=rn(gen, 2 * R, scale=0.1), dx_out=rn(gen, B, T, R),
                dskip_out=rn(gen, B, T, R))


def assert_scaled(got, ref, tol=1e-4):
    err = float((got - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), err


@pytest.mark.parametrize("B,T,R", [(20, 512, 512), (2, 70, 64), (3, 17, 128)])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_residual_block_training_kernels(gen, B, T, R, d):
    """K1's training mode (g, z), gate backward (dz) and input backward (dx,
    ds) against their plain versions: <= 1e-4 of each output's scale, and a
    second launch bit-equal (B=20 x 512 x 512 is a training step's shape)."""
    a = k1_training_inputs(gen, B, T, R)
    gate = (a["x"], a["step"], a["cond"], a["w_conv"], a["b_conv"], d)
    g, z = wavenet.residual_gate_train(*gate)
    ref_g, ref_z = wavenet.residual_gate_train_reference(*gate)
    assert_scaled(g, ref_g)
    assert_scaled(z, ref_z)
    assert torch.equal(g, wavenet.residual_gate(*gate))  # serving's kernel, same tile
    dz = wavenet.residual_gate_backward(a["dx_out"], a["dskip_out"], ref_z, a["w_out"])
    ref_dz = wavenet.residual_gate_backward_reference(a["dx_out"], a["dskip_out"], ref_z,
                                                      a["w_out"])
    assert_scaled(dz, ref_dz)
    assert torch.equal(dz, wavenet.residual_gate_backward(a["dx_out"], a["dskip_out"], ref_z,
                                                          a["w_out"]))
    dx, ds = wavenet.residual_input_backward(ref_dz, a["dx_out"], a["w_conv"], d)
    ref_dx, ref_ds = wavenet.residual_input_backward_reference(ref_dz, a["dx_out"],
                                                               a["w_conv"], d)
    assert_scaled(dx, ref_dx)
    assert_scaled(ds, ref_ds)
    dx2, ds2 = wavenet.residual_input_backward(ref_dz, a["dx_out"], a["w_conv"], d)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.parametrize("B,T", [(4, 1024), (1, 256), (3, 333), (20, 512), (1, 1536)])
@pytest.mark.parametrize("d", [1, 8, 400])
def test_k1_forward_on_the_tensor_cores(gen, B, T, d):
    """K1's forward on the 3xTF32 wgmma core at R = 512, in each plan the
    rule picks from B T (64 x 64 tiles at 256, 333 x 3; 128 x 128 at 1536,
    4 x 1024, 20 x 512 on an H100): ``wavenet_gate`` and ``wavenet_out``
    within 1e-3 of their plain versions (``chip_smoke.py``'s kernel phase),
    ``wavenet_gate_train`` within 1e-4 of each output's scale, the training
    instance's g equal to serving's, each a second launch bit-equal, with
    ``prepare``'s split weights and without (the wrapper splits them)
    alike; one launch a call (T = 333: ragged tiles that cross items; d =
    400 >= T there)."""
    R = 512
    assert kernels.load_library("wavenet_block").wavenet_forward_plan(B, T, R) == (
        2 if B * T > 1024 else 1)
    a = k1_training_inputs(gen, B, T, R)
    cs, os_ = wavenet.tf32_split(a["w_conv"]), wavenet.tf32_split(a["w_out"])
    gate = (a["x"], a["step"], a["cond"], a["w_conv"], a["b_conv"], d)
    before = {k: kernels.LAUNCHES[k] for k in ("wavenet_gate", "wavenet_gate_train",
                                                "wavenet_out")}
    g = wavenet.residual_gate(*gate, cs)
    ref_g, ref_z = wavenet.residual_gate_train_reference(*gate)
    torch.testing.assert_close(g, ref_g, atol=1e-3, rtol=0)
    assert torch.equal(g, wavenet.residual_gate(*gate, cs))
    assert torch.equal(g, wavenet.residual_gate(*gate))
    g_t, z = wavenet.residual_gate_train(*gate, cs)
    assert_scaled(g_t, ref_g)
    assert_scaled(z, ref_z)
    assert torch.equal(g_t, g)
    again = wavenet.residual_gate_train(*gate, cs)
    assert torch.equal(again[0], g_t) and torch.equal(again[1], z)
    out = (ref_g, a["x"], a["skip"], a["w_out"], a["b_out"])
    got = wavenet.residual_out(*out, os_)
    for o, r in zip(got, wavenet.residual_out_reference(*out)):
        torch.testing.assert_close(o, r, atol=1e-3, rtol=0)
        assert_scaled(o, r)
    assert all(torch.equal(o, r) for o, r in zip(got, wavenet.residual_out(*out)))
    assert {k: kernels.LAUNCHES[k] - v for k, v in before.items()} == {
        "wavenet_gate": 3, "wavenet_gate_train": 2, "wavenet_out": 2}


@pytest.mark.parametrize("d", [1, 8])
def test_residual_block_function_on_the_card(gen, d):
    """``ResidualBlockFunction`` through the kernels against torch autograd
    of ``residual_block_reference``: every gradient <= 1e-4 of its scale."""
    B, T, R = 2, 96, 128
    a = k1_training_inputs(gen, B, T, R)
    names = ("x", "skip", "step", "cond", "w_conv", "b_conv", "w_out", "b_out")

    def grads(fn):
        leaves = [a[n].clone().requires_grad_(True) for n in names]
        out = fn(*leaves, d)
        torch.autograd.backward(out, (a["dx_out"], a["dskip_out"]))
        return [t.detach() for t in out] + [t.grad for t in leaves]

    kernels.reset_launches()
    got = grads(wavenet.ResidualBlockFunction.apply)
    for name in ("wavenet_gate_train", "wavenet_out", "wavenet_gate_backward",
                 "wavenet_input_backward", "wavenet_weight_grad"):
        assert kernels.LAUNCHES[name] == 1, name
    assert kernels.LAUNCHES["wavenet_weight_split"] == 3  # each wrapper splits its own
    assert kernels.LAUNCHES["conv1d_wgrad"] == 0
    for got_t, ref_t in zip(got, grads(wavenet.residual_block_reference)):
        assert_scaled(got_t, ref_t)


@pytest.mark.parametrize("B,T", [(3, 333), (20, 512)])
@pytest.mark.parametrize("d", [1, 8, 400])
def test_k1_backward_on_the_tensor_cores(gen, B, T, d):
    """K1's weight gradients (``wavenet_weight_grad``) and input backward
    (``wavenet_input_backward``), both 3xTF32 on the tensor cores, at R =
    512: <= 1e-4 of each output's scale against their plain versions, and a
    second launch bit-equal (T = 333: ragged tiles and chunks that cross
    items; d = 400 >= T there)."""
    R = 512
    y, dz, g = rn(gen, B, T, R), rn(gen, B, T, 2 * R), rn(gen, B, T, R)
    dx_out, dskip_out = rn(gen, B, T, R), rn(gen, B, T, R)
    w_conv = rn(gen, 3 * R, 2 * R, scale=(3 * R) ** -0.5)
    before = kernels.LAUNCHES["wavenet_weight_grad"]
    got = wavenet.residual_weight_grad(y, dz, g, dx_out, dskip_out, d)
    assert kernels.LAUNCHES["wavenet_weight_grad"] == before + 1
    for a, r in zip(got, wavenet.residual_weight_grad_reference(y, dz, g, dx_out, dskip_out, d)):
        assert_scaled(a, r)
    again = wavenet.residual_weight_grad(y, dz, g, dx_out, dskip_out, d)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dx, ds = wavenet.residual_input_backward(dz, dx_out, w_conv, d)
    ref_dx, ref_ds = wavenet.residual_input_backward_reference(dz, dx_out, w_conv, d)
    assert_scaled(dx, ref_dx)
    assert_scaled(ds, ref_ds)
    dx2, ds2 = wavenet.residual_input_backward(dz, dx_out, w_conv, d)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.parametrize("B,T,plan", [(20, 512, 3), (3, 1000, 2), (3, 333, 1)])
def test_k1_gate_backward_on_the_tensor_cores(gen, B, T, plan):
    """K1's gate backward on the 3xTF32 wgmma core at R = 512, in each plan
    its rule picks from M = B T on an H100's SMs (3 = 128 x 64, 2 = 128 x
    128, 1 = 64 x 64; T = 1000 and 333: ragged tiles that cross items):
    <= 1e-4 of dz's scale against the plain version, a second launch
    bit-equal; with ``prepare``'s split and without it alike, one launch a
    call."""
    R = 512
    a = k1_training_inputs(gen, B, T, R)
    z = rn(gen, B, T, 2 * R, scale=2.0)
    args = (a["dx_out"], a["dskip_out"], z, a["w_out"])
    ref = wavenet.residual_gate_backward_reference(*args)
    assert kernels.load_library("wavenet_block").wavenet_gate_backward_plan(B, T, R) == plan
    w_split = wavenet.split_weights([a["w_out"]], [False], [True])[1][0]
    before = kernels.LAUNCHES["wavenet_gate_backward"]
    dz = wavenet.residual_gate_backward(*args, w_split)
    assert kernels.LAUNCHES["wavenet_gate_backward"] == before + 1
    assert_scaled(dz, ref)
    assert torch.equal(dz, wavenet.residual_gate_backward(*args, w_split))
    assert torch.equal(dz, wavenet.residual_gate_backward(*args))


def test_weight_split_on_the_card(gen):
    """K1's split kernel, one launch for a table of weights at R = 512 (the
    forward's w_conv transposed, w_out in both layouts from one read, a
    weight as stored only, one off the 32 x 32 tile): bit-equal to
    ``tf32_split``; past the table's 64 weights it raises."""
    R = 512
    ws = [rn(gen, 3 * R, 2 * R, scale=1e-3), rn(gen, R, 2 * R, scale=30.0), rn(gen, R, 2 * R),
          rn(gen, 37, 70)]
    transposed, stored = [True, True, False, True], [False, True, True, True]
    before = kernels.LAUNCHES["wavenet_weight_split"]
    got_t, got_n = wavenet.split_weights(ws, transposed, stored)
    assert kernels.LAUNCHES["wavenet_weight_split"] == before + 1
    for w, t, n, g_t, g_n in zip(ws, transposed, stored, got_t, got_n):
        assert (g_t is None) != t and (g_n is None) != n
        assert g_t is None or torch.equal(g_t, wavenet.tf32_split(w))
        assert g_n is None or torch.equal(g_n, wavenet.tf32_split(w.t()))
    many = [rn(gen, 64, 96) for _ in range(65)]
    with pytest.raises(RuntimeError):
        wavenet.split_weights(many, [True] * 65, [False] * 65)


def test_unipc_step(gen):
    """K2: <= 1e-5 relative (one or two roundings apart)."""
    t = [rn(gen, 3, 37, 16) for _ in range(6)]
    coeffs = (0.97, -0.3, 0.1, -0.05, 1.7, 0.4)
    got = diffusion.unipc_predict(*t[:4], *coeffs)
    torch.testing.assert_close(got, diffusion.unipc_predict_reference(*t[:4], *coeffs),
                               atol=1e-5, rtol=1e-5)
    corr = (0.6, 0.8, 0.97, -0.3, 0.1, -0.05, 0.2, 1.7, 0.4)
    got = diffusion.unipc_correct(*t, *corr)
    ref = diffusion.unipc_correct_reference(*t, *corr)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_plms_and_ddpm_updates(gen):
    """K2-PLMS and K2-naive: <= 1e-5 relative (one or two roundings apart)."""
    t = [rn(gen, 3, 37, 16) for _ in range(5)]
    args = (*t, *diffusion.PLMS_WEIGHTS[1], 0.01, 3.1, 2.7)
    torch.testing.assert_close(diffusion.plms_update(*args),
                               diffusion.plms_update_reference(*args), atol=1e-5, rtol=1e-5)
    args = (t[0], t[1], t[2], 1.3, 0.4, 0.6, 0.39, 0.05)
    torch.testing.assert_close(diffusion.ddpm_update(*args),
                               diffusion.ddpm_update_reference(*args), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "B,n_fft,win,hop,F",
    # powers of two (a segment of 637 and one of 1024 frames at 2048, the
    # 4096 / 540 / 2160 mel scale with 102 KB of shared memory, 64) and
    # Bluestein (2299 = 11 * 11 * 19, 1933 prime, 1149 = 3 * 383, 300);
    # odd frame counts leave the last frame unpaired
    [(1, 2048, 2048, 512, 5), (2, 2299, 2299, 512, 33), (2, 300, 240, 75, 40),
     (1, 64, 48, 16, 10), (1, 2048, 2048, 512, 637), (1, 2048, 2048, 512, 1024),
     (1, 1933, 1933, 512, 21), (2, 1149, 1000, 300, 7), (2, 4096, 2160, 540, 13)],
)
def test_stft_magnitude(gen, B, n_fft, win, hop, F):
    """K5: <= 1e-5 relative to the largest magnitude, and its exact
    forward (float64) within 1e-6 of every magnitude's own value of the
    plain version run in float64; one launch a call."""
    y = rn(gen, B, n_fft + (F - 1) * hop + hop // 3, scale=0.3)
    before = kernels.LAUNCHES["stft_magnitude"]
    got = mel.stft_magnitude(y, n_fft, hop, win)
    assert kernels.LAUNCHES["stft_magnitude"] == before + 1
    ref = mel.stft_magnitude_reference(y, n_fft, hop, win)
    torch.testing.assert_close(got, ref, atol=1e-5 * ref.abs().max().item(), rtol=0)
    exact = mel.stft_magnitude(y, n_fft, hop, win, exact=True)
    assert kernels.LAUNCHES["stft_magnitude"] == before + 2
    ref64 = mel.stft_magnitude_reference(y.double(), n_fft, hop, win)
    assert ((exact.double() - ref64).abs() / ref64).max().item() <= 1e-6


def test_stft_magnitude_raises_past_its_limit(gen):
    """K5 takes every n_fft up to ``MAX_N_FFT`` (the split path past shared
    memory); past it the wrappers raise."""
    y = rn(gen, 1, mel.MAX_N_FFT + 512)
    with pytest.raises(ValueError, match=str(mel.MAX_N_FFT)):
        mel.stft_magnitude(y, mel.MAX_N_FFT + 1, 512)
    g = rn(gen, 1, (mel.MAX_N_FFT + 1) // 2 + 1, 1)
    with pytest.raises(ValueError, match=str(mel.MAX_N_FFT)):
        mel.stft_backward(g, y, mel.MAX_N_FFT + 1, 512)


@pytest.mark.parametrize("n_fft,win,hop,F,exact", [
    (6000, 6000, 512, 9, True),     # Bluestein, L = 16384: float64 past shared memory
    (16384, 16384, 4096, 6, False),  # a power of two past shared memory, float32
    (16384, 12000, 4096, 5, True),
])
def test_stft_split_path(gen, n_fft, win, hop, F, exact):
    """The sizes shared memory does not hold, once refused: the forward
    against the plain version (float32: <= 1e-5 of the largest magnitude;
    float64: every magnitude within 1e-6 of its own value) and, with
    ``exact``, the backward (float64) <= 1e-5 of the gradient's scale,
    each one launch."""
    B = 2
    T_pad = n_fft + (F - 1) * hop + hop // 3
    y = rn(gen, B, T_pad, scale=0.3)
    before = dict(kernels.LAUNCHES)
    got = mel.stft_magnitude(y, n_fft, hop, win, exact=exact)
    assert kernels.LAUNCHES["stft_magnitude"] == before["stft_magnitude"] + 1
    if exact:
        ref = mel.stft_magnitude_reference(y.double(), n_fft, hop, win)
        assert ((got.double() - ref).abs() / ref).max().item() <= 1e-6
        g = rn(gen, *got.shape)
        grad = mel.stft_backward(g, y, n_fft, hop, win)
        assert kernels.LAUNCHES["stft_backward"] == before["stft_backward"] + 1
        ref_g = mel.stft_backward_reference(g.double(), y.double(), n_fft, hop, win)
        assert (grad.double() - ref_g).abs().max().item() <= 1e-5 * ref_g.abs().max().item()
    else:
        ref = mel.stft_magnitude_reference(y, n_fft, hop, win)
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


QUIET_CASES = [(2048, 512, 12), (1933, 512, 11), (512, 128, 21)]


def quiet_case(n_fft, hop, F, seed, device="cpu"):
    """A signal whose middle stretch is 1e-5 as loud as the rest, so that
    a frame there pairs with a loud one (K5 packs two frames in one complex
    transform), and a magnitude gradient that grows as 1 / |X| there, as a
    log-mel loss's does: (y [1, T], g [1, bins, F])."""
    gen = torch.Generator(device=device).manual_seed(seed)
    T_pad = n_fft + (F - 1) * hop
    y = torch.randn((1, T_pad), generator=gen, device=device) * 0.3
    y[:, T_pad // 3: T_pad // 3 + n_fft + 2 * hop] *= 1e-5
    mag = mel.stft_magnitude_reference(y, n_fft, hop)
    g = torch.randn(mag.shape, generator=gen, device=device) / (mag + 1e-5) * 1e-6
    return y, g.contiguous()


@pytest.mark.parametrize("n_fft,hop,F", QUIET_CASES)
def test_stft_near_silence(gen, n_fft, hop, F):
    """K5 where a quiet frame pairs with a loud one: every frame's
    magnitudes within 1e-5 of that frame's own peak of plain, the exact
    forward's every magnitude within 1e-6 of its own value, the backward
    within 1e-5 of the gradient's scale."""
    y, g = quiet_case(n_fft, hop, F, n_fft, "cuda")
    mag = mel.stft_magnitude(y, n_fft, hop)
    ref = mel.stft_magnitude_reference(y, n_fft, hop)
    assert ((mag - ref).abs() / ref.abs().amax(dim=1, keepdim=True)).max().item() <= 1e-5
    ref64 = mel.stft_magnitude_reference(y.double(), n_fft, hop)
    exact = mel.stft_magnitude(y, n_fft, hop, exact=True)
    assert ((exact.double() - ref64).abs() / ref64).max().item() <= 1e-6
    got = mel.stft_backward(g, y, n_fft, hop)
    ref_g = mel.stft_backward_reference(g, y, n_fft, hop)
    torch.testing.assert_close(got, ref_g, atol=1e-5 * ref_g.abs().max().item(), rtol=0)


@pytest.mark.parametrize("B,T,K", [(3, 500, 4), (2, 1, 4), (1, 30, 2)])
def test_viterbi_candidates(gen, B, T, K):
    """K8-cand: path and f0 identical to the plain version, ties included."""
    freqs = torch.rand((B, T, K), generator=gen, device="cuda") * 1050 + 50
    freqs = freqs * (torch.rand((B, T, K), generator=gen, device="cuda") > 0.3)
    strengths = torch.rand((B, T, K), generator=gen, device="cuda") * 2 - 1
    unvoiced = torch.rand((B, T), generator=gen, device="cuda") * 1.5
    strengths[:, ::7] = 0.5  # ties between candidates of equal frequency
    freqs[:, ::7] = 220.0
    got = pitch.viterbi_candidates(freqs, strengths, unvoiced)
    ref = pitch.viterbi_candidates_reference(freqs, strengths, unvoiced)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)


@pytest.mark.parametrize("kind,B,T,K,plan", [
    ("random", 1, 2600, 4, "chip"),  # a 30 s segment
    ("grid", 4, 1024, 4, "chip"), ("inf", 2, 1025, 4, "chip"),
    # streamed in the card's 227 KB: K = 31 past 4632 frames, K = 15 (16
    # states) past 8288
    ("random", 1, 8000, 31, "streamed"), ("inf", 2, 6000, 31, "streamed"),
    ("grid", 1, 9000, 15, "streamed"),
    ("random", 2, 1000, 31, "chip"), ("grid", 2, 700, 9, "chip"),
    ("random", 2, 1, 1, "chip"), ("random", 3, 2, 1, "chip"), ("grid", 2, 2, 31, "chip"),
])
def test_viterbi_candidates_plans(gen, kind, B, T, K, plan):
    """K8-cand at either plan, at the card's sizes, K = 1 and 31, T = 1 and
    2, exact ties and +-inf strengths (``candidate_case``): path and f0
    identical to the plain version."""
    assert kernels.load_library("viterbi").viterbi_candidates_plan(T, K, 0) == (
        plan == "streamed")
    args = [torch.from_numpy(a).cuda() for a in candidate_case(kind, B, T, K, seed=T + K)]
    got = pitch.viterbi_candidates(*args)
    ref = pitch.viterbi_candidates_reference(*args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)


def candidate_case(kind: str, B: int, T: int, K: int, seed: int):
    """K8-cand's inputs (freqs, strengths [B, T, K], unvoiced [B, T],
    float32) made with numpy: ``random`` (about 30% of the candidates
    empty); ``grid`` (frequencies from 0, 110, 220 and 440 Hz, strengths and
    unvoiced strengths on a grid of 0.25: exact ties in the recursion and
    in the final argmax); ``inf`` (random, with -inf strengths for about a
    fifth of the candidates of the first half, and a +inf strength at 3/4 of
    T, after which every state ties at +inf; the unvoiced state stays finite,
    so no sum meets +inf and -inf)."""
    rng = np.random.default_rng(seed)
    freqs = (rng.random((B, T, K)) * 1050 + 50) * (rng.random((B, T, K)) > 0.3)
    strengths = rng.random((B, T, K)) * 2 - 1
    unvoiced = rng.random((B, T)) * 1.5
    if kind == "grid":
        freqs = rng.choice([0.0, 110.0, 220.0, 440.0], (B, T, K))
        strengths = rng.integers(-4, 5, (B, T, K)) * 0.25
        unvoiced = rng.integers(0, 5, (B, T)) * 0.25
    elif kind == "inf":
        half = strengths[:, : T // 2]
        half[rng.random(half.shape) < 0.2] = -np.inf
        strengths[:, 3 * T // 4, 0] = np.inf
    return tuple(a.astype(np.float32) for a in (freqs, strengths, unvoiced))


def dense_case(kind: str, B: int, T: int, seed: int, ties: bool = False, S: int = 430):
    """Inputs of K8 dense as pYIN (S = 430, its transition matrix) or CREPE
    (S = 360: bins outside 12-166 at -inf, the last quarter of the frames
    uniform pad rows, delta_0 = -log(S) + obs_0) give them, observations on
    a grid of 0.5; or ``flat`` (S = 430, a constant matrix); or ``edges``
    (``flat`` whose last frame favours only the states on either side of
    each boundary between blocks of 28 states, so that the final argmax
    ties across the blocks of a cluster of 16 or 8, 28 or 56 states each
    at S = 430: state 27 must win); or ``random`` (S states, any S: a
    row-stochastic random matrix).
    With ``ties``: every frame favours the even states by 8
    but the last, which favours the odd ones; the states whose transition
    rows are cut by an edge are kept out (pYIN: voiced bins 0-7 and from
    207, and the unvoiced states, at -100; CREPE: its -inf bins), and CREPE
    takes no pad rows. The matrices are then symmetric around every state
    left, so an odd state's best predecessors j - 1 and j + 1 tie exactly,
    as do the odd states of the last frame: the first index must win in the
    recursion and in the final argmax."""
    if kind == "random":
        gen = torch.Generator().manual_seed(seed)
        log_obs = torch.round(torch.rand((B, T, S), generator=gen) * -16) / 2
        rows = torch.rand((S, S), generator=gen) + 1e-3
        log_A = torch.log(rows / rows.sum(dim=1, keepdim=True))
        return pitch.pyin_delta0(log_obs), log_obs.contiguous(), log_A
    if kind == "edges":
        delta0, log_obs, log_A = dense_case("flat", B, T, seed)
        last = torch.full((430,), -2.0)
        for edge in range(28, 430, 28):
            last[edge - 1 : edge + 1] = 0.0
        log_obs[:, -1] = last
        return pitch.pyin_delta0(log_obs), log_obs.contiguous(), log_A
    gen = torch.Generator().manual_seed(seed)
    S = 360 if kind == "crepe" else 430
    if kind == "flat":
        # a constant matrix and observations on five values: the maximum
        # of delta ties across the whole state range, every frame
        log_obs = torch.round(torch.rand((B, T, S), generator=gen) * -4) / 2
        log_A = torch.full((S, S), -math.log(S))
        return pitch.pyin_delta0(log_obs), log_obs.contiguous(), log_A
    log_obs = torch.round(torch.rand((B, T, S), generator=gen) * -16) / 2
    if ties:
        log_obs = torch.where(torch.arange(S) % 2 == 0, 0.0, -8.0).expand(B, T, S).clone()
        log_obs[:, -1] = torch.where(torch.arange(S) % 2 == 1, 0.0, -8.0)
        if kind == "pyin":
            log_obs[:, :, :8] = -100.0
            log_obs[:, :, 207:] = -100.0
    if kind == "pyin":
        log_A = torch.from_numpy(pitch._pyin_transition(215, 0.01, 8))
        return pitch.pyin_delta0(log_obs), log_obs.contiguous(), log_A
    log_A = torch.log(torch.clamp(torch.from_numpy(crepe._transition_matrix()), min=1e-12))
    log_obs[:, :, :12] = -math.inf
    log_obs[:, :, 166:] = -math.inf
    if not ties:
        log_obs[:, T - T // 4 :] = -math.log(360.0)
    return pitch.crepe_delta0(log_obs), log_obs.contiguous(), log_A


DENSE_CASES = [
    ("pyin", 2, 300, False, 430), ("crepe", 2, 256, False, 360), ("pyin", 1, 1, False, 430),
    ("crepe", 1, 2, False, 360), ("pyin", 1, 40, True, 430), ("crepe", 1, 40, True, 360),
    ("flat", 2, 40, False, 430), ("edges", 1, 40, False, 430), ("random", 2, 40, False, 1),
    ("random", 2, 40, False, 33), ("random", 1, 40, False, 511),
    # the pitch path's shapes: one pYIN call, one CREPE call of a 24 s request
    ("pyin", 1, 1025, False, 430), ("crepe", 1, 2560, False, 360)]


@pytest.mark.parametrize("kind,B,T,ties,S", DENSE_CASES)
def test_viterbi_dense(gen, kind, B, T, ties, S):
    """K8 dense (pYIN: 430 states; CREPE: 360 with -inf bins and uniform
    pad rows; observations on a grid of 0.5, so that many scores tie; state
    counts that no cluster of 8 or 16 divides, 1, 33 and 511; final-argmax ties
    across the cluster's blocks; the pitch path's own shapes): the path
    identical to the plain version's, one launch per call under each
    wrapper's name."""
    delta0, log_obs, log_A = (t.cuda() for t in dense_case(kind, B, T, seed=T, ties=ties, S=S))
    wrapper = pitch.crepe_viterbi if kind == "crepe" else pitch.pyin_viterbi
    name = "crepe_viterbi" if kind == "crepe" else "pyin_viterbi"
    before = kernels.LAUNCHES[name]
    got = wrapper(log_obs, log_A)
    assert kernels.LAUNCHES[name] == before + 1
    ref = pitch.viterbi_dense_reference(delta0, log_obs, log_A)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    torch.testing.assert_close(
        pitch._viterbi_dense(name, delta0, log_obs, log_A), ref, atol=0, rtol=0)
    with pytest.raises(ValueError, match="512 states"):
        wrapper(torch.zeros((1, 3, 600), device="cuda"), torch.zeros((600, 600), device="cuda"))


@pytest.mark.parametrize("hop", [64, 512])
def test_nsf_source(gen, hop):
    """K3, one launch of ``nsf_merge`` a pass with the frame-phase scan
    inside: the merged source <= 1e-4 of the plain composition (one
    sincospif a sample, the harmonics by rotation) and bit-equal to the
    kernel given ``nsf_phase_base_reference``'s bases (the scan's sums are
    exact in any order), at iSTFTNet's trunk rate and NSF-HiFiGAN's hop, on
    1300 frames (6 tiles of the scan); 17 harmonics raise before a
    launch."""
    B, T = 4, 1300
    f0 = torch.rand((B, T), generator=gen, device="cuda") * 500 + 80
    f0 = f0 * (torch.rand((B, T), generator=gen, device="cuda") > 0.3)
    rand_ini = torch.rand((B, 9), generator=gen, device="cuda")
    rand_ini[:, 0] = 0
    noise = rn(gen, B, T * hop, 9)
    weight, bias = rn(gen, 9, scale=0.3), rn(gen, 1, scale=0.1)
    args = (f0, rand_ini, noise, weight, bias, 44100, hop)
    before = kernels.LAUNCHES["nsf_merge"]
    got = source.nsf_source(*args)
    assert kernels.LAUNCHES["nsf_merge"] == before + 1
    torch.testing.assert_close(got, source.nsf_source_reference(*args), atol=1e-4, rtol=0)
    base = source.nsf_phase_base_reference(f0, 44100, hop)
    assert torch.equal(source.nsf_merge(f0, base, rand_ini, noise, weight, bias, 44100, hop),
                       got)
    wide = torch.zeros((B, 17), device="cuda")
    with pytest.raises(ValueError, match="harmonics"):
        source.nsf_merge(f0, None, wide, rn(gen, B, T * hop, 17), rn(gen, 17), bias, 44100,
                         hop)
    assert kernels.LAUNCHES["nsf_merge"] == before + 2


@pytest.mark.parametrize(
    "C_in,C_out,K,stride,dil,pad,slope,res,tanh",
    [
        (128, 70, 7, 1, 1, 3, None, False, False),
        (32, 32, 11, 1, 5, 25, 0.1, True, False),
        (16, 16, 3, 1, 3, 3, 0.1, False, False),
        (1, 256, 128, 64, 1, 32, None, True, False),
        (1, 24, 16, 8, 1, 4, None, False, False),
        (16, 1, 7, 1, 1, 3, 0.01, False, True),
    ],
)
def test_conv1d(gen, C_in, C_out, K, stride, dil, pad, slope, res, tanh):
    """K4 direct conv: <= 1e-4 relative to the output's scale."""
    B, T = 2, 64 * stride + 5
    x = rn(gen, B, T, C_in)
    w, b = rn(gen, C_out, C_in, K, scale=(C_in * K) ** -0.5), rn(gen, C_out)
    T_out = (T + 2 * pad - dil * (K - 1) - 1) // stride + 1
    residual = rn(gen, B, T_out, C_out) if res else None
    kw = dict(stride=stride, dilation=dil, padding=pad, in_slope=slope,
              residual=residual, tanh=tanh)
    got = nsf_hifigan.conv1d(x, w, b, **kw)
    ref = nsf_hifigan.conv1d_reference(x, w, b, **kw)
    torch.testing.assert_close(got, ref, atol=1e-4 * max(1.0, ref.abs().max().item()),
                               rtol=0)


@pytest.mark.parametrize("C_in,C_out,K,u", [(96, 48, 16, 8), (32, 16, 4, 2), (4, 2, 4, 2)])
def test_conv_transpose1d(gen, C_in, C_out, K, u):
    """K4 transposed conv: <= 1e-4 relative to the output's scale."""
    x = rn(gen, 2, 51, C_in)
    w, b = rn(gen, C_in, C_out, K, scale=(C_in * K / u) ** -0.5), rn(gen, C_out)
    got = nsf_hifigan.conv_transpose1d(x, w, b, u, (K - u) // 2, in_slope=0.1)
    ref = nsf_hifigan.conv_transpose1d_reference(x, w, b, u, (K - u) // 2, in_slope=0.1)
    torch.testing.assert_close(got, ref, atol=1e-4 * max(1.0, ref.abs().max().item()),
                               rtol=0)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = rn(gen, 2, 8, 96)  # 96 channels: not a multiple of 64
    with pytest.raises(ValueError, match="multiple of 64"):
        wavenet.residual_gate(x, rn(gen, 2, 96), rn(gen, 2, 8, 192),
                              rn(gen, 288, 192), rn(gen, 192), 1)
    with pytest.raises(TypeError, match="float32"):
        wavenet.residual_weight_grad(*(rn(gen, 2, 8, c).double() for c in (64, 128, 64, 64, 64)),
                                     1)
    with pytest.raises(ValueError, match="dz"):
        wavenet.residual_weight_grad(*(rn(gen, 2, 8, 64) for _ in range(5)), 1)
    with pytest.raises(ValueError, match="contiguous"):
        nsf_hifigan.conv1d(rn(gen, 2, 16, 8).transpose(1, 2), rn(gen, 4, 16, 3),
                           rn(gen, 4))
    with pytest.raises(TypeError, match="float32"):
        diffusion.unipc_predict(*(rn(gen, 4, 4).double() for _ in range(4)),
                                1.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    # K6 2-D's transposed mode runs stride 1 in H: a strided input gradient
    # with stride 2 there raises before any launch
    before = kernels.LAUNCHES["conv2d_transposed"]
    with pytest.raises(ValueError, match="stride 1 in H"):
        blocked_conv.conv2d_input_grad(rn(gen, 2, 4, 5, 8), rn(gen, 8, 8, 3, 9), (8, 9),
                                       (2, 2), (1, 4))
    assert kernels.LAUNCHES["conv2d_transposed"] == before


@pytest.mark.parametrize(
    "B,n_fft,win,hop,F",
    # the training losses' scales (hop 270 and 540 do not divide n_fft), a
    # short one, and Bluestein at 1933, 2299 and 1149 (odd frame counts)
    [(2, 512, 512, 128, 33), (1, 2048, 1080, 270, 20), (2, 4096, 2160, 540, 9),
     (1, 256, 200, 100, 4), (1, 1933, 1933, 512, 7), (2, 2299, 2299, 512, 6),
     (1, 1149, 1149, 300, 11)],
)
def test_stft_backward(gen, B, n_fft, win, hop, F):
    """K5 in training: the magnitude <= 1e-5 of plain; the backward, which
    recomputes the spectrum from the signal, <= 1e-5 of the gradient's
    scale; one launch of each a call."""
    T_pad = n_fft + (F - 1) * hop + hop // 2
    y = rn(gen, B, T_pad, scale=0.3).requires_grad_()
    before = dict(kernels.LAUNCHES)
    mag = mel.stft_magnitude(y, n_fft, hop, win)
    ref_mag = mel.stft_magnitude_reference(y.detach(), n_fft, hop, win)
    torch.testing.assert_close(mag, ref_mag, atol=1e-5 * ref_mag.abs().max().item(), rtol=0)
    g = rn(gen, *mag.shape)
    (got,) = torch.autograd.grad(mag, y, g)
    assert kernels.LAUNCHES["stft_magnitude"] == before["stft_magnitude"] + 1
    assert kernels.LAUNCHES["stft_backward"] == before["stft_backward"] + 1
    ref = mel.stft_backward_reference(g, y.detach(), n_fft, hop, win)
    torch.testing.assert_close(got, ref, atol=1e-5 * ref.abs().max().item(), rtol=0)


@pytest.mark.parametrize(
    "C_in,C_out,groups,stride,T",
    # MSD layers 1, 2 and 5 (their widths per group), and stride 4
    [(128, 128, 4, 2, 301), (128, 256, 16, 2, 150), (1024, 1024, 16, 1, 37),
     (64, 128, 2, 4, 30)],
)
def test_grouped_conv1d_and_its_gradients(gen, C_in, C_out, groups, stride, T):
    """K6 forward, its input gradient (transposed mode) and its weight
    gradient (conv1d_wgrad) through autograd, against the plain version's
    autograd: <= 1e-4 of each one's scale."""
    K = 41
    x = rn(gen, 2, T, C_in).requires_grad_()
    w = rn(gen, C_out, C_in // groups, K, scale=(K * C_in / groups) ** -0.5).requires_grad_()
    b = rn(gen, C_out).requires_grad_()
    out = blocked_conv.grouped_conv1d(x, w, b, stride, groups)
    gy = rn(gen, *out.shape)
    got = torch.autograd.grad(out, (x, w, b), gy)
    ref_out = blocked_conv.grouped_conv1d_reference(x, w, b, stride, groups)
    ref = torch.autograd.grad(ref_out, (x, w, b), gy)
    for g_, r_ in zip((out,) + got, (ref_out,) + ref):
        torch.testing.assert_close(g_, r_, atol=1e-4 * r_.abs().max().item(), rtol=0)


@pytest.mark.parametrize(
    "C_in,C_out,K,stride,dil,pad,slope,res,tanh",
    [
        (128, 70, 7, 1, 1, 3, None, False, False),    # conv_pre (no input gradient)
        (32, 32, 11, 1, 5, 25, 0.1, True, False),     # resblock conv
        (16, 16, 3, 1, 3, 3, 0.1, False, False),
        (1, 256, 128, 64, 1, 32, None, True, False),  # noise conv: transposed dgrad
        (16, 1, 7, 1, 1, 3, 0.01, False, True),       # conv_post with tanh
        (1, 16, 1, 1, 1, 0, None, True, False),       # the last noise conv
    ],
)
def test_conv1d_gradients(gen, C_in, C_out, K, stride, dil, pad, slope, res, tanh):
    """K4's input gradient (through K4) and weight gradient
    (conv1d_wgrad) against autograd of the plain version: <= 1e-4 of each
    one's scale."""
    B, T = 2, 64 * stride
    x = rn(gen, B, T, C_in).requires_grad_(C_in != 128)
    w = rn(gen, C_out, C_in, K, scale=(C_in * K) ** -0.5).requires_grad_()
    b = rn(gen, C_out).requires_grad_()
    T_out = (T + 2 * pad - dil * (K - 1) - 1) // stride + 1
    r = rn(gen, B, T_out, C_out).requires_grad_() if res else None
    kw = dict(stride=stride, dilation=dil, padding=pad, in_slope=slope, residual=r, tanh=tanh)
    inputs = [t for t in (x, w, b, r) if t is not None and t.requires_grad]
    out = nsf_hifigan.conv1d(x, w, b, **kw)
    gy = rn(gen, *out.shape)
    got = torch.autograd.grad(out, inputs, gy)
    ref = torch.autograd.grad(nsf_hifigan.conv1d_reference(x, w, b, **kw), inputs, gy)
    for g_, r_ in zip(got, ref):
        torch.testing.assert_close(g_, r_, atol=1e-4 * r_.abs().max().item(), rtol=0)


@pytest.mark.parametrize("C_in,C_out,K,u", [(96, 48, 16, 8), (32, 16, 4, 2)])
def test_conv_transpose1d_gradients(gen, C_in, C_out, K, u):
    """K4's transposed conv: input gradient through K4's strided conv and
    weight gradient through conv1d_wgrad, <= 1e-4 of each one's scale."""
    x = rn(gen, 2, 51, C_in).requires_grad_()
    w = rn(gen, C_in, C_out, K, scale=(C_in * K / u) ** -0.5).requires_grad_()
    b = rn(gen, C_out).requires_grad_()
    out = nsf_hifigan.conv_transpose1d(x, w, b, u, (K - u) // 2, in_slope=0.1)
    gy = rn(gen, *out.shape)
    got = torch.autograd.grad(out, (x, w, b), gy)
    ref = torch.autograd.grad(nsf_hifigan.conv_transpose1d_reference(
        x, w, b, u, (K - u) // 2, in_slope=0.1), (x, w, b), gy)
    for g_, r_ in zip(got, ref):
        torch.testing.assert_close(g_, r_, atol=1e-4 * r_.abs().max().item(), rtol=0)


@pytest.mark.parametrize("B,T,hop,H", [(3, 50, 256, 9), (2, 37, 16, 9), (2, 45, 64, 1)])
def test_nsf_merge_backward(gen, B, T, hop, H):
    """K3's backward with the frame-phase scan inside: dW and db <= 1e-4 of
    their scale (sums over every sample in another order), at the modules' 9
    harmonics and 1, with a ragged last chunk at hop 16; a second call, and
    the kernel given the reference's bases, give the same bits; one launch a
    call; 17 harmonics raise before a launch."""
    f0 = torch.rand((B, T), generator=gen, device="cuda") * 500 + 80
    f0 = f0 * (torch.rand((B, T), generator=gen, device="cuda") > 0.3)
    rand_ini = torch.rand((B, H), generator=gen, device="cuda")
    rand_ini[:, 0] = 0
    noise = rn(gen, B, T * hop, H)
    out = source.nsf_merge_reference(f0, None, rand_ini, noise, rn(gen, H, scale=0.3),
                                     rn(gen, 1, scale=0.1), 44100, hop)
    g = rn(gen, *out.shape)
    args = (g, out, f0, None, rand_ini, noise, 44100, hop)
    before = kernels.LAUNCHES["nsf_merge_backward"]
    got = source.nsf_merge_backward(*args)
    assert kernels.LAUNCHES["nsf_merge_backward"] == before + 1
    for got_, ref in zip(got, source.nsf_merge_backward_reference(*args)):
        torch.testing.assert_close(got_, ref, atol=1e-4 * ref.abs().max().item(), rtol=0)
    again = source.nsf_merge_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    base = source.nsf_phase_base_reference(f0, 44100, hop)
    given = source.nsf_merge_backward(g, out, f0, base, rand_ini, noise, 44100, hop)
    assert all(torch.equal(a, b) for a, b in zip(got, given))
    wide = torch.zeros((B, 17), device="cuda")
    with pytest.raises(ValueError, match="harmonics"):
        source.nsf_merge_backward(g, out, f0, None, wide, rn(gen, B, T * hop, 17), 44100, hop)
    assert kernels.LAUNCHES["nsf_merge_backward"] == before + 3


@pytest.mark.parametrize(
    "C_in,C_out,k,stride,pad,H,W",
    # the MRD's layers 0 (C_in 1), 1-3 (stride 2 in F), 4 and conv_post
    # (C_out 1), with odd and even widths
    [(1, 32, (3, 9), (1, 1), (1, 4), 37, 129), (32, 32, (3, 9), (1, 2), (1, 4), 21, 65),
     (32, 32, (3, 9), (1, 2), (1, 4), 19, 64), (32, 32, (3, 3), (1, 1), (1, 1), 23, 17),
     (32, 1, (3, 3), (1, 1), (1, 1), 30, 17)],
)
def test_conv2d_and_its_gradients(gen, C_in, C_out, k, stride, pad, H, W):
    """K6 2-D forward, its input gradient (direct mode with flipped taps, or
    the transposed mode) and its weight gradient (conv2d_wgrad) through
    autograd, against the plain version's autograd: <= 1e-4 of each one's
    scale."""
    x = rn(gen, 2, H, W, C_in).requires_grad_()
    w = rn(gen, C_out, C_in, *k, scale=(C_in * k[0] * k[1]) ** -0.5).requires_grad_()
    b = rn(gen, C_out).requires_grad_()
    out = blocked_conv.conv2d_nhwc(x, w, b, stride, pad)
    gy = rn(gen, *out.shape)
    got = torch.autograd.grad(out, (x, w, b), gy)
    ref_out = blocked_conv.conv2d_nhwc_reference(x, w, b, stride, pad)
    ref = torch.autograd.grad(ref_out, (x, w, b), gy)
    for g_, r_ in zip((out,) + got, (ref_out,) + ref):
        torch.testing.assert_close(g_, r_, atol=1e-4 * r_.abs().max().item(), rtol=0)


@pytest.mark.parametrize("kind", ["mrd_layer_1", "msd_layer_1"])
def test_weight_gradients_at_training_shapes(gen, kind):
    """The weight gradients at a training step's own shapes (batch 16 x
    32768 samples): the MRD's layer 1 at its first resolution (273 frames x
    513 bins, 32 -> 32, k (3, 9), stride (1, 2)) through conv2d_wgrad, and
    the MSD's layer 1 (128 -> 128, k 41, stride 2, 4 groups) through
    conv1d_wgrad: <= 1e-4 of the plain version's scale, and a second
    launch bit-equal to the first (partial sums added in a fixed order)."""
    if kind == "mrd_layer_1":
        x, g = rn(gen, 16, 273, 513, 32), rn(gen, 16, 273, 257, 32)
        args = ((3, 9), (1, 2), (1, 4))
        got, again = (blocked_conv.conv2d_wgrad(x, g, *args) for _ in range(2))
        ref = blocked_conv.conv2d_wgrad_reference(x, g, *args)
    else:
        x, g = rn(gen, 16, 32768, 128), rn(gen, 16, 16384, 128)
        args = (41, 2, 1, 20, 4)
        got, again = (blocked_conv.conv1d_wgrad(x, g, *args) for _ in range(2))
        ref = blocked_conv.conv1d_wgrad_reference(x, g, *args)
    torch.testing.assert_close(got, ref, atol=1e-4 * ref.abs().max().item(), rtol=0)
    assert torch.equal(got, again)


def at_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one float past a
    16-byte boundary (a view into a larger buffer)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("kind", ["conv1d", "conv2d"])
def test_weight_gradients_unaligned(gen, kind):
    """The weight gradients on views at an offset (not 16-byte aligned):
    their 16-byte copies give way to 4-byte ones, so the result is the
    aligned inputs' bit for bit, and within 1e-4 of the plain version."""
    if kind == "conv1d":
        x, g = rn(gen, 4, 2048, 64), rn(gen, 4, 2048, 64)
        fn = lambda x_, g_: blocked_conv.conv1d_wgrad(x_, g_, 11, 1, 5, 25, 1, 0.1)  # noqa: E731
        ref = blocked_conv.conv1d_wgrad_reference(x, g, 11, 1, 5, 25, 1, 0.1)
    else:
        x, g = rn(gen, 2, 40, 129, 32), rn(gen, 2, 40, 65, 32)
        fn = lambda x_, g_: blocked_conv.conv2d_wgrad(x_, g_, (3, 9), (1, 2), (1, 4))  # noqa: E731
        ref = blocked_conv.conv2d_wgrad_reference(x, g, (3, 9), (1, 2), (1, 4))
    aligned = fn(x, g)
    for x_, g_ in ((at_offset(x), g), (x, at_offset(g)), (at_offset(x), at_offset(g))):
        assert torch.equal(fn(x_, g_), aligned)
    torch.testing.assert_close(aligned, ref, atol=1e-4 * ref.abs().max().item(), rtol=0)


def _forward_case(gen, kind):
    """(fn, inputs, plain): the forward core at one of the shapes its
    redesign targets; ``fn(*inputs)`` runs the kernel."""
    if kind.startswith("k4_c"):  # the widest resblock convs of the vocoder pass
        C, T = (256, 8192) if kind == "k4_c256" else (128, 16384)
        x, r = rn(gen, 4, T, C), rn(gen, 4, T, C)
        w, b = rn(gen, C, C, 11, scale=(C * 11) ** -0.5), rn(gen, C)
        kw = dict(dilation=5, padding=25, in_slope=0.1)
        return ((lambda r_, x_: nsf_hifigan.conv1d(x_, w, b, residual=r_, **kw)), (r, x),
                nsf_hifigan.conv1d_reference(x, w, b, residual=r, **kw))
    if kind == "k4_strided_dgrad":  # a noise conv's input gradient, the transposed mode
        x = rn(gen, 2, 32768, 1).requires_grad_()
        w, b = rn(gen, 128, 1, 16, scale=16 ** -0.5), rn(gen, 128)
        gy = rn(gen, 2, 4096, 128)
        (ref,) = torch.autograd.grad(nsf_hifigan.conv1d_reference(x, w, b, 8, 1, 4), x, gy)

        def fn(g_):
            return torch.autograd.grad(nsf_hifigan.conv1d(x, w, b, stride=8, padding=4), x, g_)[0]

        return fn, (gy,), ref
    if kind == "mrd_layer1_res0":
        x, w, b = rn(gen, 16, 273, 513, 32), rn(gen, 32, 32, 3, 9, scale=864 ** -0.5), rn(gen, 32)
        return ((lambda x_: blocked_conv.conv2d_nhwc(x_, w, b, (1, 2), (1, 4))), (x,),
                blocked_conv.conv2d_nhwc_reference(x, w, b, (1, 2), (1, 4)))
    if kind == "mrd_layer1_res0_dgrad":  # the transposed mode, stride (1, 2)
        x = torch.zeros((16, 273, 513, 32), device="cuda", requires_grad=True)
        w, gy = rn(gen, 32, 32, 3, 9, scale=864 ** -0.5), rn(gen, 16, 273, 257, 32)
        (ref,) = torch.autograd.grad(blocked_conv.conv2d_nhwc_reference(x, w, None, (1, 2), (1, 4)),
                                     x, gy)
        return ((lambda g_: blocked_conv.conv2d_input_grad(g_, w, (273, 513), (1, 2), (1, 4))),
                (gy,), ref)
    if kind.startswith("msd_layer"):  # scale 0 of the MSD: (T_in, C_in, C_out, stride, groups)
        T_in, C_in, C_out, stride, groups = {"1": (32768, 128, 128, 2, 4),
                                             "2": (16384, 128, 256, 2, 16),
                                             "5": (512, 1024, 1024, 1, 16)}[kind[9]]
        x = rn(gen, 16, T_in, C_in)
        w = rn(gen, C_out, C_in // groups, 41, scale=(41 * C_in / groups) ** -0.5)
        if not kind.endswith("dgrad"):
            b = rn(gen, C_out)
            return ((lambda x_: blocked_conv.grouped_conv1d(x_, w, b, stride, groups)), (x,),
                    blocked_conv.grouped_conv1d_reference(x, w, b, stride, groups))
        x.requires_grad_()
        out = blocked_conv.grouped_conv1d_reference(x, w, None, stride, groups)
        gy = rn(gen, *out.shape)
        (ref,) = torch.autograd.grad(out, x, gy)
        return ((lambda g_: blocked_conv._grouped_input_grad(g_, w, T_in, stride, groups)), (gy,),
                ref)
    # the stride-1 input gradients of MRD layer 0 (32 -> 1 channel) and of
    # conv_post (1 -> 32), the direct mode with flipped taps
    if kind == "mrd_layer0_dgrad":
        shape, w, k, pad = (16, 273, 513, 1), rn(gen, 32, 1, 3, 9, scale=27 ** -0.5), 32, (1, 4)
    else:
        shape, w, k, pad = (16, 273, 65, 32), rn(gen, 1, 32, 3, 3, scale=288 ** -0.5), 1, (1, 1)
    x = torch.zeros(shape, device="cuda", requires_grad=True)
    gy = rn(gen, *shape[:3], k)
    (ref,) = torch.autograd.grad(blocked_conv.conv2d_nhwc_reference(x, w, None, (1, 1), pad), x, gy)
    return ((lambda g_: blocked_conv.conv2d_input_grad(g_, w, shape[1:3], (1, 1), pad)), (gy,),
            ref)


@pytest.mark.parametrize("kind", ["k4_c256", "k4_c128", "k4_strided_dgrad", "mrd_layer1_res0",
                                  "mrd_layer0_dgrad", "mrd_post_dgrad", "mrd_layer1_res0_dgrad",
                                  "msd_layer1", "msd_layer1_dgrad", "msd_layer2",
                                  "msd_layer2_dgrad", "msd_layer5", "msd_layer5_dgrad"])
def test_forward_convs_at_training_shapes(gen, kind):
    """The forward core (csrc/conv_fwd.cuh) at the shapes of a training
    step: NSF-HiFiGAN's widest convs (C = 256 and 128, k = 11, d = 5,
    with the residual), a noise conv's strided input gradient through K4's
    transposed mode, MRD layer 1 at its first resolution (batch 16 x 32768
    samples) and its input gradient (K6 2-D's transposed mode), layer 0's
    and conv_post's stride-1 input gradients, and MSD scale 0's grouped
    layers 1, 2 and 5, forward and input gradient (K6's transposed mode):
    within 1e-4 of the plain version's scale, a second launch bit-equal
    (one float32 sum per output, in a fixed order), and the same bits with
    each input at an offset (4-byte copies, scalar stores)."""
    fn, inputs, ref = _forward_case(gen, kind)
    got = fn(*inputs)
    torch.testing.assert_close(got, ref, atol=1e-4 * ref.abs().max().item(), rtol=0)
    assert torch.equal(fn(*inputs), got)
    for i in range(len(inputs)):
        assert torch.equal(fn(*inputs[:i], at_offset(inputs[i]), *inputs[i + 1:]), got)


@pytest.mark.parametrize("hop", [16, 256])
def test_comb_tooth(gen, hop):
    """K9: ``comb_tooth`` one launch of ``comb_merge`` with the linear
    frame-phase scan inside, <= 1e-5 of the plain composition on a
    0.1-amplitude template; ``comb_merge`` given the reference's bases
    <= 1e-5 of ``comb_merge_reference``; with unvoiced frames, jumps and f0
    near sr / 2."""
    B, T, sr = 3, 70, 44100
    f0 = torch.rand((B, T), generator=gen, device="cuda") * 700 + 80
    f0 = f0 * (torch.rand((B, T), generator=gen, device="cuda") > 0.2)
    f0[0, 10] = sr / 2 - 50
    noise = rn(gen, B, T * hop)
    before = kernels.LAUNCHES["comb_merge"]
    got = source.comb_tooth(f0, noise, sr, hop)
    assert kernels.LAUNCHES["comb_merge"] == before + 1
    torch.testing.assert_close(got, source.comb_tooth_reference(f0, noise, sr, hop), atol=1e-5,
                               rtol=0)
    ref_base = source.nsf_phase_base_reference(f0, sr, hop, "linear")
    got = source.comb_merge(f0, ref_base, noise, sr, hop)
    ref = source.comb_merge_reference(f0, ref_base, noise, sr, hop)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,n_fft,win,hop,F,center", [
    (4, 16, 16, 8, 257, True), (1, 16, 12, 4, 40, False), (2, 64, 48, 27, 9, True),
    (2, 2048, 2048, 512, 33, True), (2, 2299, 2299, 512, 17, True),
    (1, 16384, 16384, 4096, 5, True)])
def test_istft(gen, B, n_fft, win, hop, F, center):
    """K5 istft: every sample within 1e-5 of its own scale
    (``chip_smoke.istft_scale``) and of the output's largest value, against
    the plain version (cuFFT's float32 inverse); the direct plan (n_fft 16),
    the FFT core (64, 2048; 2299 by Bluestein) and the split path (16384 at
    hop 4096); one launch a call."""
    bins = n_fft // 2 + 1
    re, im = rn(gen, B, bins, F), rn(gen, B, bins, F)
    before = kernels.LAUNCHES["istft"]
    got = mel.istft(re, im, n_fft, hop, win, center)
    assert kernels.LAUNCHES["istft"] == before + 1
    ref = mel.istft_reference(re, im, n_fft, hop, win, center)
    torch.testing.assert_close(got, ref, atol=1e-5 * ref.abs().max().item(), rtol=0)
    if center and win == n_fft:
        assert ((got - ref).abs() <= 1e-5 * istft_scale(re, im, n_fft, hop)).all()
    with pytest.raises(ValueError, match="expected"):
        mel.istft(re[:, 1:].contiguous(), im[:, 1:].contiguous(), n_fft, hop)


@pytest.mark.parametrize("plan,n_fft,hop,F", [
    ("direct", 16, 8, 257), ("direct", 32, 16, 65), ("fft", 2048, 512, 33),
    ("fft", 2299, 512, 10), ("split", 16384, 4096, 5), ("split", 9000, 2000, 6)])
def test_istft_plans(gen, plan, n_fft, hop, F):
    """Each K5 istft plan, at sizes its rule gives it, on spectra whose
    pairs hold a loud and a quiet frame: every sample within 1e-5 of its
    own scale; one launch a call."""
    assert mel.istft_plan(n_fft, hop, F) == plan
    bins = n_fft // 2 + 1
    re, im = rn(gen, 2, bins, F), rn(gen, 2, bins, F)
    re[..., 1::2] *= 1e-6
    im[..., 1::2] *= 1e-6
    before = kernels.LAUNCHES["istft"]
    got = mel.istft(re, im, n_fft, hop)
    assert kernels.LAUNCHES["istft"] == before + 1
    ref = mel.istft_reference(re, im, n_fft, hop)
    assert ((got - ref).abs() <= 1e-5 * istft_scale(re, im, n_fft, hop)).all()


def istft_scale(real, imag, n_fft: int, hop: int):
    """Each output sample's own scale (as ``chip_smoke.py``'s): the plain
    istft of a spectrum whose frames hold only (2 / n_fft) sum_k (|re| +
    |im|), at DC."""
    dc = torch.zeros_like(real)
    dc[:, 0] = (real.abs() + imag.abs()).sum(1) * 2.0
    return mel.istft_reference(dc, torch.zeros_like(imag), n_fft, hop)


@pytest.mark.parametrize("H,hop", [(1, 256), (3, 16)])
def test_sine_merge(gen, H, hop):
    """K9 sine (the linear frame-phase scan inside, one launch): the template
    <= 1e-5 of the plain version's on a voiced and unvoiced f0 with a value
    near sr / 2, in both forms and given the reference's bases; the training
    form's written signals <= 1e-5 of the plain version's; the merge's
    gradients (the analytic backward on those signals) <= 1e-4 relative."""
    B, T, sr = 3, 70, 44100
    f0 = torch.rand((B, T), generator=gen, device="cuda") * 700 + 80
    f0 = f0 * (torch.rand((B, T), generator=gen, device="cuda") > 0.2)
    f0[0, 10] = sr / 2 - 50
    base = None  # the kernel's own linear scan; the plain version's cumsum
    rand_ini = torch.rand((B, H), generator=gen, device="cuda")
    rand_ini[:, 0] = 0
    noise = rn(gen, B, T * hop, H)
    weight, bias = rn(gen, H, scale=H ** -0.5), rn(gen, 1, scale=0.1)
    args = (f0, base, rand_ini, noise, weight, bias, sr, hop)
    before = kernels.LAUNCHES["sine_merge"]
    got = source.sine_template(f0, rand_ini, noise, weight, bias, sr, hop)
    assert kernels.LAUNCHES["sine_merge"] == before + 1
    torch.testing.assert_close(got, source.sine_merge_reference(*args), atol=1e-5, rtol=0)
    ref_base = source.nsf_phase_base_reference(f0, sr, hop, "linear")
    given = (f0, ref_base) + args[2:]
    torch.testing.assert_close(source.sine_merge(*given), source.sine_merge_reference(*given),
                               atol=1e-5, rtol=0)
    out, signals = source._sine_merge_forward(*args, 0.1, 0.003, with_signals=True)
    ref, ref_signals = source._sine_merge_plain(*args, 0.1, 0.003)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(signals, ref_signals, atol=1e-5, rtol=0)
    g = rn(gen, B, T * hop, 1)
    grads = []
    for fn in (source.sine_merge, source.sine_merge_reference):
        w, b = weight.clone().requires_grad_(), bias.clone().requires_grad_()
        (fn(f0, base, rand_ini, noise, w, b, sr, hop) * g).sum().backward()
        grads.append((w.grad, b.grad))
    for got_g, ref_g in zip(*grads):
        torch.testing.assert_close(got_g, ref_g, atol=1e-4 * ref_g.abs().max().item(), rtol=0)


ALIGN_B, ALIGN_T_Y, ALIGN_T_X = 4, 24, 10
ALIGN_CASES = [("random", 0), ("random", 1), ("ties", 2), ("ties", 3), ("flat", 4)]


def align_case(kind: str, seed: int):
    """K7's inputs (values [4, 24, 10], t_ys, t_xs with t_x <= t_y) made
    with numpy: random values, integer values (their float32 sums are
    exact, so the backtrack's ``same < left`` meets equal operands) or a
    flat grid; item 0 has t_x = t_y, item 1 t_x = 1, item 2 the full grid."""
    rng = np.random.default_rng(seed)
    shape = (ALIGN_B, ALIGN_T_Y, ALIGN_T_X)
    values = {
        "random": lambda: rng.standard_normal(shape),
        "ties": lambda: rng.integers(0, 2, shape),
        "flat": lambda: np.zeros(shape),
    }[kind]().astype(np.float32)
    t_xs = rng.integers(2, ALIGN_T_X + 1, ALIGN_B)
    t_ys = np.maximum(rng.integers(ALIGN_T_X, ALIGN_T_Y + 1, ALIGN_B), t_xs)
    t_ys[0], t_xs[1] = t_xs[0], 1
    t_ys[2], t_xs[2] = ALIGN_T_Y, ALIGN_T_X
    return values, t_ys.astype(np.int32), t_xs.astype(np.int32)


@pytest.mark.parametrize("kind,seed", ALIGN_CASES)
def test_maximum_path(gen, kind, seed):
    """K7: paths identical to the plain version's and to the numpy golden
    DP's, ties included (the parity test's cases)."""
    values, t_ys, t_xs = (torch.from_numpy(a).cuda() for a in align_case(kind, seed))
    got = ma.maximum_path(values, t_ys, t_xs)
    ref = ma.maximum_path_reference(values, t_ys, t_xs)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert (got.cpu().numpy() == ma.maximum_path_numpy(
        values.cpu().numpy(), t_ys.cpu().numpy(), t_xs.cpu().numpy())).all()


@pytest.mark.parametrize("B,T_y,T_x", [(32, 1000, 200), (2, 1200, 1100)])
def test_maximum_path_wide(gen, B, T_y, T_x):
    """K7 at the alignment phase's shape and past four positions a thread
    (1100), integer values (ties), lengths drawn per item: identical."""
    values = torch.randint(0, 3, (B, T_y, T_x), generator=gen, device="cuda").float()
    t_xs = torch.randint(T_x // 2, T_x + 1, (B,), generator=gen, device="cuda")
    t_ys = torch.maximum(torch.randint(T_y // 2, T_y + 1, (B,), generator=gen,
                                       device="cuda"), t_xs)
    got = ma.maximum_path(values, t_ys, t_xs)
    torch.testing.assert_close(got, ma.maximum_path_reference(values, t_ys, t_xs),
                               atol=0, rtol=0)


@pytest.mark.parametrize("B,T_y,T_x,plan", [
    (32, 1000, 200, "chip"),  # the align phase's shape
    # streamed in the card's 227 KB
    (2, 1200, 1100, "streamed"), (2, 8000, 100, "streamed"), (4, 2000, 500, "streamed"),
    (2, 4000, 100, "chip"), (2, 60, 2016, "chip"), (3, 1, 300, "chip"), (3, 300, 1, "chip"),
])
def test_maximum_path_plans(gen, B, T_y, T_x, plan):
    """K7 at either plan, at the card's sizes, over the whole grid, t_x =
    t_y, t_x = 1 and drawn lengths, integer values (ties;
    ``align_wide_case``): identical to the plain version."""
    assert kernels.load_library("monotonic_align").maximum_path_plan(T_y, T_x, 0) == (
        plan == "streamed")
    values, t_ys, t_xs = (torch.from_numpy(a).cuda() for a in align_wide_case(B, T_y, T_x, T_y))
    got = ma.maximum_path(values, t_ys, t_xs)
    torch.testing.assert_close(got, ma.maximum_path_reference(values, t_ys, t_xs),
                               atol=0, rtol=0)


@pytest.mark.parametrize("T_y,T_x", [(10, 2017), (75705, 2016), (107193, 1)])
def test_maximum_path_refuses(gen, T_y, T_x):
    """Past 2016 text positions, or past the rows whose indices fit in
    shared memory (75,704 at 2016 positions, 107,192 at one), the public
    ``maximum_path`` raises ValueError before it launches: the count stays."""
    values = torch.zeros((1, T_y, T_x), device="cuda")
    lengths = torch.tensor([T_y], dtype=torch.int32), torch.tensor([T_x], dtype=torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="exceeds the kernel"):
        ma.maximum_path(values, *lengths)
    assert kernels.LAUNCHES["maximum_path"] == 0


def align_wide_case(B: int, T_y: int, T_x: int, seed: int):
    """K7's inputs at [B, T_y, T_x], made with numpy: integer values 0-2
    (exact ties), item 0 over the whole grid (t_x = t_y where T_x >= T_y),
    item 1 with t_x = 1, the others lengths drawn with t_x <= t_y <= T_y."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 3, (B, T_y, T_x)).astype(np.float32)
    t_xs = rng.integers(1, min(T_x, T_y) + 1, B)
    t_ys = np.maximum(rng.integers(1, T_y + 1, B), t_xs)
    t_ys[0], t_xs[0] = T_y, min(T_x, T_y)
    if B > 1:
        t_xs[1] = 1
    return values, t_ys.astype(np.int32), t_xs.astype(np.int32)


def convnext_case(B: int, T: int, C: int, seed: int, masked: bool, zero_bias: bool = False,
                  device="cpu"):
    """K10's inputs (x, step, cond, mask, k, b, ln_scale, ln_bias), float32:
    item 0 unpadded, the others padded from about 3/5 of T (with
    ``masked``); with ``zero_bias`` the conv's bias is 0, as at init, so
    the rows whose taps all lie in padding have variance 0."""
    gen = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    x, step, cond = rn(B, T, C), rn(B, C), rn(B, T, C)
    lens = torch.tensor([T] + [max(1, (3 * T) // 5 - i) for i in range(1, B)])
    mask = torch.arange(T)[None, :] >= lens[:, None] if masked else None
    k = rn(convnext.TAPS, C, scale=convnext.TAPS ** -0.5)
    b = torch.zeros(C) if zero_bias else rn(C, scale=0.1)
    ln_scale, ln_bias = 1.0 + rn(C, scale=0.1), rn(C, scale=0.1)
    args = (x, step, cond, mask, k, b, ln_scale, ln_bias)
    return tuple(None if a is None else a.to(device) for a in args)


@pytest.mark.parametrize("B,T,C", [(4, 1024, 512), (2, 37, 24), (3, 5, 64), (1, 130, 520)])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_depthwise_conv7_norm(gen, B, T, C, d):
    """K10 with and without a mask (padded rows whose taps all lie in
    padding and a zero conv bias give the ln bias): <= 1e-4 of the plain
    version's scale, and a second launch bit-equal (B=4 x 1024 x 512 is the
    batch request's shape; T=5 is shorter than the halo)."""
    for masked, zero_bias in ((False, False), (True, False), (True, True)):
        args = convnext_case(B, T, C, B * T + C + d, masked, zero_bias, device="cuda")
        got = convnext.depthwise_conv7_norm(*args, d)
        ref = convnext.depthwise_conv7_norm_reference(*args, d)
        assert torch.isfinite(got).all()
        assert_scaled(got, ref)
        assert torch.equal(got, convnext.depthwise_conv7_norm(*args, d))


K10_GRADS = ("dx", "dstep", "dcond", "dk", "db", "dln_scale", "dln_bias")


@pytest.mark.parametrize("B,T,C", [(20, 512, 512), (2, 37, 24), (3, 5, 64), (1, 130, 520)])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_depthwise_conv7_norm_backward(gen, B, T, C, d):
    """K10's backward (one kernel, dh on chip, and its slots' sum) with and
    without a mask (go nonzero at padded rows; a zero conv bias gives padded
    rows of variance 0): every gradient <= 1e-4 of the plain backward's
    scale and within 1e-4 relative L2, bit-equal on a second launch (B=20 x
    512 x 512 is a training step's shape)."""
    for masked, zero_bias in ((False, False), (True, False), (True, True)):
        args = convnext_case(B, T, C, B * T + C + d, masked, zero_bias, device="cuda")
        go = rn(gen, B, T, C)
        got = convnext.depthwise_conv7_norm_backward(go, *args, d)
        ref = convnext.depthwise_conv7_norm_backward_reference(go, *args, d)
        for name, g, r in zip(K10_GRADS, got, ref):
            assert torch.isfinite(g).all(), name
            assert_scaled(g, r)
            assert float((g - r).norm() / r.norm()) <= 1e-4, name
        again = convnext.depthwise_conv7_norm_backward(go, *args, d)
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def test_depthwise_conv7_norm_backward_widest(gen):
    """K10's backward at ``MAX_TRAIN_CHANNELS`` (4 channels a thread, the
    stages filling shared memory) against the plain backward, and a
    ValueError one channel past it."""
    C = convnext.MAX_TRAIN_CHANNELS
    args = convnext_case(2, 40, C, 3, True, device="cuda")
    go = rn(gen, 2, 40, C)
    got = convnext.depthwise_conv7_norm_backward(go, *args, 2)
    for name, g, r in zip(K10_GRADS, got,
                          convnext.depthwise_conv7_norm_backward_reference(go, *args, 2)):
        assert_scaled(g, r)
    args = convnext_case(1, 8, C + 1, 3, False, device="cuda")
    with pytest.raises(ValueError):
        convnext.depthwise_conv7_norm_backward(rn(gen, 1, 8, C + 1), *args, 1)


def test_depthwise_conv7_norm_refuses_training_width(gen):
    """Under grad, a width past ``MAX_TRAIN_CHANNELS`` (which the forward
    alone takes) is refused by the forward, before a backward could run."""
    C = convnext.MAX_TRAIN_CHANNELS + 1
    x, step, cond, mask, k, b, w, lb = convnext_case(1, 8, C, 3, False, device="cuda")
    with torch.no_grad():
        assert convnext.depthwise_conv7_norm(x, step, cond, mask, k, b, w, lb, 1).shape == x.shape
    with pytest.raises(ValueError):
        convnext.depthwise_conv7_norm(x.requires_grad_(True), step, cond, mask, k, b, w, lb, 1)


@pytest.mark.parametrize("d", [1, 8])
def test_depthwise_conv7_norm_function_on_the_card(gen, d):
    """Under grad the wrapper takes ``DepthwiseConv7NormFunction``: K10's
    forward and its backward once each, every gradient <= 1e-4
    of its scale against torch autograd of the plain version; with grad
    off, the serving kernel alone."""
    args = convnext_case(2, 96, 128, d, True, device="cuda")
    go = rn(gen, 2, 96, 128)

    def grads(fn):
        x, step, cond, mask, k, b, w, lb = args
        leaves = [t.clone().requires_grad_(True) for t in (x, step, cond, k, b, w, lb)]
        x, step, cond, k, b, w, lb = leaves
        out = fn(x, step, cond, mask, k, b, w, lb, d)
        out.backward(go)
        return [out.detach()] + [t.grad for t in leaves]

    kernels.reset_launches()
    got = grads(convnext.depthwise_conv7_norm)
    for name in ("depthwise_conv7_norm", "depthwise_conv7_norm_backward"):
        assert kernels.LAUNCHES[name] == 1, name
    for got_t, ref_t in zip(got, grads(convnext.depthwise_conv7_norm_reference)):
        assert_scaled(got_t, ref_t)
    kernels.reset_launches()
    with torch.no_grad():
        convnext.depthwise_conv7_norm(*args, d)
    assert kernels.LAUNCHES["depthwise_conv7_norm"] == 1
    assert kernels.LAUNCHES["depthwise_conv7_norm_backward"] == 0
