"""The port's hand-written kernels (K1-K5, K8-cand) against their plain
PyTorch versions on an NVIDIA GPU, at small shapes that exercise the ragged
edges.

These need the card (the CUDA kernels have no CPU mode, and Triton needs a
GPU); without one they skip. On the card:
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
The full-width check of every kernel is ``chip_smoke.py``."""

import pytest
import torch

from fish_diffusion_tpu_torch.extractors import pitch
from fish_diffusion_tpu_torch.models import diffusion, wavenet
from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, source
from fish_diffusion_tpu_torch.ops import mel

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
    # on an H100 (132 SMs) the rows M = B * F and the bins pick the tile:
    # 32 x 32 for the short cases, 64 x 32 for one 7.4 s segment (637
    # frames), 128 x 64 for one segment of 1024 frames
    [(1, 2048, 2048, 512, 5), (2, 2299, 2299, 512, 33), (2, 300, 240, 75, 40),
     (1, 64, 48, 16, 10), (1, 2048, 2048, 512, 637), (1, 2048, 2048, 512, 1024)],
)
def test_stft_magnitude(gen, B, n_fft, win, hop, F):
    """K5: <= 1e-5 relative to the largest magnitude."""
    y = rn(gen, B, n_fft + (F - 1) * hop + hop // 3, scale=0.3)
    basis = mel._dft_basis(n_fft, win, str(y.device))
    got = mel.stft_magnitude(y, basis, hop)
    ref = mel.stft_magnitude_reference(y, basis, hop)
    torch.testing.assert_close(got, ref, atol=1e-5 * ref.abs().max().item(), rtol=0)


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


def test_nsf_source(gen):
    """K3: phase base exact (float64 sums), merged source <= 1e-4."""
    B, T, hop = 2, 300, 256
    f0 = torch.rand((B, T), generator=gen, device="cuda") * 500 + 80
    f0 = f0 * (torch.rand((B, T), generator=gen, device="cuda") > 0.3)
    rand_ini = torch.rand((B, 9), generator=gen, device="cuda")
    rand_ini[:, 0] = 0
    noise = rn(gen, B, T * hop, 9)
    weight, bias = rn(gen, 9, scale=0.3), rn(gen, 1, scale=0.1)
    base = source.nsf_phase_base(f0, 44100, hop)
    torch.testing.assert_close(base, source.nsf_phase_base_reference(f0, 44100, hop),
                               atol=0, rtol=0)
    args = (f0, base, rand_ini, noise, weight, bias, 44100, hop)
    torch.testing.assert_close(source.nsf_merge(*args),
                               source.nsf_merge_reference(*args), atol=1e-4, rtol=0)


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
    with pytest.raises(ValueError, match="contiguous"):
        nsf_hifigan.conv1d(rn(gen, 2, 16, 8).transpose(1, 2), rn(gen, 4, 16, 3),
                           rn(gen, 4))
    with pytest.raises(TypeError, match="float32"):
        diffusion.unipc_predict(*(rn(gen, 4, 4).double() for _ in range(4)),
                                1.0, 0.0, 0.0, 0.0, 0.0, 0.0)
