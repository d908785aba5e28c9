"""Convolution helpers shared by the vocoder and the discriminators
(``fish_diffusion_tpu/ops/blocked_conv.py``).

The JAX module folded time into channels ("blocked" layouts) so that narrow
convolutions filled the TPU's 128-lane matrix unit. The port computes the
plain functions those layouts computed, channels-last ``[B, T, C]``:

- ``weight_norm_kernel``: flax ``nn.WeightNorm``'s fold, ``g * v / ||v||``
  with the norm per output feature and 1e-12 inside the square root;
- ``grouped_conv1d``: K6, the multi-scale discriminator's grouped k = 41
  convolutions (``csrc/grouped_conv1d.cu``), with pad ``k // 2`` and
  ``(t_in - 1) // stride + 1`` outputs, which is what
  ``blocked_apply_grouped`` computes. Its input gradient is the kernel's
  transposed mode (taps padded with zeros to a multiple of the stride);
- ``conv1d_wgrad``: the weight gradient of K4's and K6's convolutions
  (``csrc/conv1d_wgrad.cu``), partial sums over chunks of the batch and
  time reduction added in a fixed order.

Each kernel has its plain version beside it (``*_reference``), which the
wrappers take for CPU tensors; on a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels


def weight_norm_kernel(v: torch.Tensor, g: torch.Tensor,
                       eps: float = 1e-12) -> torch.Tensor:
    """Weight norm in torch layout: v [C_out, ...], g [C_out, 1, ...] ->
    ``g * v / sqrt(sum(v^2 over all axes but the first) + eps)``."""
    dims = tuple(range(1, v.ndim))
    return v * (g / torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + eps))


# ---------------------------------------------------------------------------
# conv1d_wgrad
# ---------------------------------------------------------------------------


def _leaky(x: torch.Tensor, slope: Optional[float]) -> torch.Tensor:
    return x if slope is None else F.leaky_relu(x, slope)


def conv1d_wgrad_reference(a, bm, K: int, stride: int = 1, dilation: int = 1,
                           padding: int = 0, groups: int = 1,
                           slope_a: Optional[float] = None,
                           slope_b: Optional[float] = None) -> torch.Tensor:
    """Plain version of ``conv1d_wgrad``: a [B, T_a, CA], bm [B, T_b, CB] ->
    dW [K, CA / groups, CB] with
    ``dW[k, i, j] = sum_{b, t} act(a)[b, t*s + k*d - p, g*CA_g + i] * act(bm)[b, t, j]``
    for the group g of column j (positions of ``a`` outside it are 0)."""
    B, T_a, CA = a.shape
    T_b, CB = bm.shape[1], bm.shape[2]
    ca_g, cb_g = CA // groups, CB // groups
    a = _leaky(a, slope_a)
    bm = _leaky(bm, slope_b).reshape(B * T_b, groups, cb_g).transpose(0, 1)
    need = (T_b - 1) * stride + (K - 1) * dilation + 1
    a = F.pad(a, (0, 0, padding, max(0, need - padding - T_a)))
    out = []
    for k in range(K):
        ak = a[:, k * dilation : k * dilation + (T_b - 1) * stride + 1 : stride]
        ak = ak.reshape(B * T_b, groups, ca_g).transpose(0, 1)
        out.append(torch.bmm(ak.transpose(1, 2), bm))  # [groups, ca_g, cb_g]
    return torch.stack(out).transpose(1, 2).reshape(K, ca_g, CB)


def conv1d_wgrad(a, bm, K: int, stride: int = 1, dilation: int = 1,
                 padding: int = 0, groups: int = 1,
                 slope_a: Optional[float] = None,
                 slope_b: Optional[float] = None) -> torch.Tensor:
    """The weight gradient of a 1-D convolution (see
    ``conv1d_wgrad_reference``), on the card by ``csrc/conv1d_wgrad.cu``.
    CPU tensors take the plain version."""
    if not a.is_cuda:
        return conv1d_wgrad_reference(a, bm, K, stride, dilation, padding,
                                      groups, slope_a, slope_b)
    kernels.require_cuda("conv1d_wgrad", a, bm)
    if a.dtype != torch.float32:
        raise TypeError(f"conv1d_wgrad: takes float32, got {a.dtype}")
    if a.ndim != 3 or bm.ndim != 3 or a.shape[0] != bm.shape[0]:
        raise ValueError(f"conv1d_wgrad: a {tuple(a.shape)}, bm {tuple(bm.shape)}: "
                         "expected [B, T_a, CA] and [B, T_b, CB]")
    B, T_a, CA = a.shape
    T_b, CB = bm.shape[1], bm.shape[2]
    if CA % groups or CB % groups:
        raise ValueError(f"conv1d_wgrad: {CA} and {CB} channels, {groups} groups")
    lib = kernels.load_library("conv1d_wgrad")
    M, cb_g = K * (CA // groups), CB // groups
    splits = lib.conv1d_wgrad_splits(M, cb_g, groups, B * T_b)
    part = torch.empty((splits, groups, M, cb_g), dtype=a.dtype, device=a.device)
    out = torch.empty((K, CA // groups, CB), dtype=a.dtype, device=a.device)
    kernels.check(
        lib.conv1d_wgrad(
            a.data_ptr(), bm.data_ptr(), part.data_ptr(), out.data_ptr(), B,
            T_a, T_b, CA, CB, K, stride, dilation, padding, groups,
            float(slope_a or 0.0), int(slope_a is not None),
            float(slope_b or 0.0), int(slope_b is not None), splits,
            kernels.stream(),
        ),
        "conv1d_wgrad",
    )
    kernels.count_launch("conv1d_wgrad")
    return out


# ---------------------------------------------------------------------------
# K6: grouped_conv1d
# ---------------------------------------------------------------------------


def grouped_out_len(t_in: int, stride: int) -> int:
    return (t_in - 1) // stride + 1


def grouped_conv1d_reference(x, weight, bias, stride: int, groups: int):
    """Plain version of K6. x [B, T, C_in]; weight [C_out, C_in / groups, K]
    (torch layout); pad K // 2 -> [B, (T - 1) // stride + 1, C_out]."""
    K = weight.shape[2]
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride, K // 2, 1, groups)
    return y.transpose(1, 2)[:, : grouped_out_len(x.shape[1], stride)]


def _grouped_packed_reference(transposed: bool, x, w_packed, bias, T_out: int,
                              stride: int, pad: int, groups: int):
    """Plain version of K6's kernel on its own operands: w_packed
    [K, C_in / groups, C_out]; the direct or transposed grouped conv, cut or
    zero-padded to T_out rows."""
    K, ci_g, C_out = w_packed.shape
    xt = x.transpose(1, 2)
    if transposed:
        co_g = C_out // groups
        w = w_packed.reshape(K, ci_g, groups, co_g).permute(2, 1, 3, 0)
        natural = (x.shape[1] - 1) * stride - 2 * pad + K
        y = F.conv_transpose1d(xt, w.reshape(groups * ci_g, co_g, K), bias, stride, pad,
                               max(0, min(stride - 1, T_out - natural)), groups)
    else:
        y = F.conv1d(xt, w_packed.permute(2, 1, 0), bias, stride, pad, 1, groups)
    y = y.transpose(1, 2)[:, :T_out]
    return F.pad(y, (0, 0, 0, T_out - y.shape[1]))


def _grouped(transposed: bool, x, w_packed, bias, T_out: int, stride: int,
             pad: int, groups: int):
    """K6 on its own operands; CPU tensors take the plain version."""
    if not x.is_cuda:
        return _grouped_packed_reference(transposed, x, w_packed, bias, T_out,
                                         stride, pad, groups)
    tensors = [x, w_packed] + ([bias] if bias is not None else [])
    kernels.require_cuda("grouped_conv1d", *tensors)
    if x.dtype != torch.float32:
        raise TypeError(f"grouped_conv1d: takes float32, got {x.dtype}")
    B, T_in, C_in = x.shape
    K, ci_g, C_out = w_packed.shape
    if ci_g * groups != C_in or C_out % groups or ci_g % 8 or (C_out // groups) % 8:
        raise ValueError(f"grouped_conv1d: {C_in} -> {C_out} channels in {groups} "
                         "groups: each group's widths must be multiples of 8")
    if transposed and K % stride:
        raise ValueError(f"grouped_conv1d: {K} taps, stride {stride}")
    out = torch.empty((B, T_out, C_out), dtype=x.dtype, device=x.device)
    kernels.check(
        kernels.load_library("grouped_conv1d").grouped_conv1d(
            int(transposed), x.data_ptr(), w_packed.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(), B,
            T_in, T_out, C_in, C_out, K, stride, pad, groups, kernels.stream(),
        ),
        "grouped_conv1d",
    )
    kernels.count_launch("grouped_conv1d")
    return out


def _grouped_forward(x, weight, bias, stride: int, groups: int):
    K = weight.shape[2]
    return _grouped(False, x, weight.permute(2, 1, 0).contiguous(), bias,
                    grouped_out_len(x.shape[1], stride), stride, K // 2, groups)


def grouped_transposed_weight(weight, stride: int, groups: int):
    """A grouped conv's weight [C_out, C_in / groups, K] re-packed for K6's
    transposed mode (its input gradient): [K', C_out / groups, C_in], zero
    taps appended up to K' % stride == 0."""
    C_out, ci_g, K = weight.shape
    co_g = C_out // groups
    packed = weight.reshape(groups, co_g, ci_g, K).permute(3, 1, 0, 2)
    packed = F.pad(packed.reshape(K, co_g, groups * ci_g), (0, 0, 0, 0, 0, -K % stride))
    return packed.contiguous()


def _grouped_input_grad(g, weight, T_in: int, stride: int, groups: int):
    """dL/dx of the grouped conv: K6's transposed mode on the output's
    gradient g [B, T_out, C_out]."""
    return _grouped(True, g, grouped_transposed_weight(weight, stride, groups), None,
                    T_in, stride, weight.shape[2] // 2, groups)


class _GroupedConv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, stride, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, groups)
        return _grouped_forward(x, weight, bias, stride, groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, groups = ctx.conf
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _grouped_input_grad(g, weight, x.shape[1], stride, groups)
        if ctx.needs_input_grad[1]:
            K = weight.shape[2]
            dw = conv1d_wgrad(x, g, K, stride, 1, K // 2, groups).permute(2, 1, 0)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1))
        return dx, dw, db, None, None


def grouped_conv1d(x, weight, bias, stride: int, groups: int):
    """K6: grouped conv with pad ``K // 2``, x [B, T, C_in] -> [B, (T - 1)
    // stride + 1, C_out]; weight [C_out, C_in / groups, K] (torch layout).
    Differentiable: the input gradient is K6's transposed mode, the weight
    gradient ``conv1d_wgrad``. CPU tensors take the plain versions."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        return _GroupedConv1d.apply(x, weight, bias, stride, groups)
    return _grouped_forward(x, weight, bias, stride, groups)
