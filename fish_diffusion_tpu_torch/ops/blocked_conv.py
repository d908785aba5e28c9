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
  (``csrc/conv1d_wgrad.cu`` on ``csrc/wgrad.cuh``), partial sums over
  chunks of the batch and time reduction added in a fixed order;
- ``conv2d_nhwc``: K6 2-D, the multi-resolution discriminator's NHWC 2-D
  convolutions (``csrc/conv2d.cu``), what ``blocked_apply_2d`` computes
  once its block-padding columns are masked. Its input gradient is the
  kernel's direct mode (stride 1: flipped taps, swapped channels) or its
  transposed mode (stride 2 in frequency); its weight gradient
  ``conv2d_wgrad``.

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
    ``conv1d_wgrad_reference``), on the card by ``csrc/conv1d_wgrad.cu``
    on ``csrc/wgrad.cuh``.
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
    splits = lib.conv1d_wgrad_splits(B, T_a, T_b, CA, CB, K, stride, dilation, padding,
                                     groups)
    kernels.check(min(splits, 0), "conv1d_wgrad")
    out = torch.empty((K, CA // groups, CB), dtype=a.dtype, device=a.device)
    part = torch.empty((splits, *out.shape), dtype=a.dtype, device=a.device)
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


# ---------------------------------------------------------------------------
# K6 2-D: conv2d_nhwc
# ---------------------------------------------------------------------------


def conv2d_out_size(n: int, k: int, s: int, p: int) -> int:
    """The JAX package's output length, ``(n + 2p - k) // s + 1``."""
    return (n + 2 * p - k) // s + 1


def conv2d_nhwc_reference(x, weight, bias, stride=(1, 1), padding=(0, 0)):
    """Plain version of K6 2-D: ``F.conv2d`` on permuted tensors. x
    [B, H, W, C_in]; weight [C_out, C_in, KH, KW] (torch layout); zero
    padding -> [B, H', W', C_out]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, tuple(stride), tuple(padding))
    return y.permute(0, 2, 3, 1)


def _conv2d_packed_reference(transposed: bool, x, w_packed, bias, out_hw, stride,
                             padding):
    """Plain version of K6 2-D's kernel on its own operands: w_packed
    [KH, KW, C_in, C_out]; the direct conv, or the transposed one (torch
    ``conv_transpose2d``, cut or padded with zeros to ``out_hw``; the
    wrapper passes no bias in that mode)."""
    xt = x.permute(0, 3, 1, 2)
    if transposed:
        y = F.conv_transpose2d(xt, w_packed.permute(2, 3, 0, 1), bias, tuple(stride),
                               tuple(padding))
    else:
        y = F.conv2d(xt, w_packed.permute(3, 2, 0, 1), bias, tuple(stride),
                     tuple(padding))
    y = y.permute(0, 2, 3, 1)[:, : out_hw[0], : out_hw[1]]
    return F.pad(y, (0, 0, 0, out_hw[1] - y.shape[2], 0, out_hw[0] - y.shape[1]))


def _conv2d(transposed: bool, x, w_packed, bias, out_hw, stride, padding):
    """K6 2-D on its own operands (``csrc/conv2d.cu``); counted as
    ``conv2d`` or ``conv2d_transposed``. CPU tensors take the plain
    version."""
    if not x.is_cuda:
        return _conv2d_packed_reference(transposed, x, w_packed, bias, out_hw,
                                        stride, padding)
    name = "conv2d_transposed" if transposed else "conv2d"
    tensors = [x, w_packed] + ([bias] if bias is not None else [])
    kernels.require_cuda(name, *tensors)
    if x.dtype != torch.float32 or x.ndim != 4 or w_packed.ndim != 4:
        raise TypeError(f"{name}: takes float32 x [B, H, W, C] and w [KH, KW, C_in, C_out]")
    B, H_in, W_in, C_in = x.shape
    KH, KW, ci, C_out = w_packed.shape
    (SH, SW), (PH, PW) = stride, padding
    if ci != C_in or (bias is not None and bias.shape != (C_out,)):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w_packed.shape)}")
    if transposed and (SH != 1 or KW % SW):
        raise ValueError(f"{name}: taps ({KH}, {KW}), stride ({SH}, {SW}): the "
                         "transposed mode takes stride 1 in H and KW a multiple of SW")
    out = torch.empty((B, *out_hw, C_out), dtype=x.dtype, device=x.device)
    kernels.check(
        kernels.load_library("conv2d").conv2d(
            int(transposed), x.data_ptr(), w_packed.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(), B,
            H_in, W_in, out_hw[0], out_hw[1], C_in, C_out, KH, KW, SH, SW, PH, PW,
            kernels.stream(),
        ),
        name,
    )
    kernels.count_launch(name)
    return out


def _conv2d_forward(x, weight, bias, stride, padding):
    KH, KW = weight.shape[2:]
    out_hw = (conv2d_out_size(x.shape[1], KH, stride[0], padding[0]),
              conv2d_out_size(x.shape[2], KW, stride[1], padding[1]))
    return _conv2d(False, x, weight.permute(2, 3, 1, 0).contiguous(), bias, out_hw,
                   stride, padding)


def conv2d_input_grad(g, weight, in_hw, stride, padding):
    """dL/dx of ``conv2d_nhwc`` from the output's gradient g
    [B, H', W', C_out]: for stride (1, 1) the direct mode with flipped taps
    and swapped channels (padding K - 1 - P), else the transposed mode with
    the weight re-packed [KH', KW', C_out, C_in] (zero taps appended up to
    multiples of the strides)."""
    KH, KW = weight.shape[2:]
    if tuple(stride) == (1, 1):
        w = weight.flip(2, 3).permute(2, 3, 0, 1).contiguous()
        return _conv2d(False, g, w, None, in_hw, (1, 1),
                       (KH - 1 - padding[0], KW - 1 - padding[1]))
    w = F.pad(weight.permute(2, 3, 0, 1),
              (0, 0, 0, 0, 0, -KW % stride[1], 0, -KH % stride[0]))
    return _conv2d(True, g, w.contiguous(), None, in_hw, stride, padding)


def conv2d_wgrad_reference(x, g, kernel_hw, stride=(1, 1), padding=(0, 0)):
    """Plain version of ``conv2d_wgrad``: x [B, H, W, C_in], g
    [B, H', W', C_out] -> dW [KH, KW, C_in, C_out] with
    ``dW[kh, kw, c, o] = sum_{b, h, w} x[b, h*SH + kh - PH, w*SW + kw - PW, c]
    * g[b, h, w, o]`` (positions outside x are 0)."""
    (KH, KW), (SH, SW), (PH, PW) = kernel_hw, stride, padding
    B, Ho, Wo, C_out = g.shape
    xp = F.pad(x, (0, 0, PW, PW + KW, PH, PH + KH))
    gm = g.reshape(B * Ho * Wo, C_out)
    out = []
    for kh in range(KH):
        for kw in range(KW):
            xs = xp[:, kh : kh + (Ho - 1) * SH + 1 : SH, kw : kw + (Wo - 1) * SW + 1 : SW]
            out.append(xs.reshape(B * Ho * Wo, -1).t() @ gm)
    return torch.stack(out).reshape(KH, KW, x.shape[3], C_out)


def conv2d_wgrad(x, g, kernel_hw, stride=(1, 1), padding=(0, 0)):
    """The weight gradient of ``conv2d_nhwc`` (see
    ``conv2d_wgrad_reference``), on the card by ``csrc/conv2d.cu`` on
    ``csrc/wgrad.cuh``: partial sums over chunks of the B x H' x W'
    reduction, added in chunk order.
    CPU tensors take the plain version."""
    if not x.is_cuda:
        return conv2d_wgrad_reference(x, g, kernel_hw, stride, padding)
    kernels.require_cuda("conv2d_wgrad", x, g)
    if x.dtype != torch.float32 or x.ndim != 4 or g.ndim != 4 or x.shape[0] != g.shape[0]:
        raise ValueError(f"conv2d_wgrad: x {tuple(x.shape)}, g {tuple(g.shape)}: "
                         "expected float32 [B, H, W, C_in] and [B, H', W', C_out]")
    (KH, KW), (SH, SW), (PH, PW) = kernel_hw, stride, padding
    B, H_in, W_in, C_in = x.shape
    _, H_out, W_out, C_out = g.shape
    lib = kernels.load_library("conv2d")
    splits = lib.conv2d_wgrad_splits(B, H_in, W_in, H_out, W_out, C_in, C_out, KH, KW, SH,
                                     SW, PH, PW)
    kernels.check(min(splits, 0), "conv2d_wgrad")
    out = torch.empty((KH, KW, C_in, C_out), dtype=x.dtype, device=x.device)
    part = torch.empty((splits, *out.shape), dtype=x.dtype, device=x.device)
    kernels.check(
        lib.conv2d_wgrad(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(),
                         B, H_in, W_in, H_out, W_out, C_in, C_out, KH, KW, SH, SW,
                         PH, PW, splits, kernels.stream()),
        "conv2d_wgrad",
    )
    kernels.count_launch("conv2d_wgrad")
    return out


class _Conv2dNHWC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding)
        return _conv2d_forward(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.conf
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_input_grad(g, weight, x.shape[1:3], stride, padding)
        if ctx.needs_input_grad[1]:
            dw = conv2d_wgrad(x, g, weight.shape[2:], stride, padding).permute(3, 2, 0, 1)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1, 2))
        return dx, dw, db, None, None


def conv2d_nhwc(x, weight, bias, stride=(1, 1), padding=(0, 0)):
    """K6 2-D: x [B, H, W, C_in] (channels last), weight [C_out, C_in, KH, KW]
    (torch layout), zero padding, ``(n + 2p - k) // s + 1`` outputs per axis
    -> [B, H', W', C_out]. Differentiable: the input gradient is K6 2-D's
    direct (stride 1) or transposed mode, the weight gradient
    ``conv2d_wgrad``. CPU tensors take the plain versions."""
    stride, padding = tuple(stride), tuple(padding)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        return _Conv2dNHWC.apply(x, weight, bias, stride, padding)
    return _conv2d_forward(x, weight, bias, stride, padding)
