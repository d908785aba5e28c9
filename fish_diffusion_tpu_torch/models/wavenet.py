"""WaveNet (DiffWave-style) denoiser (``fish_diffusion_tpu/models/wavenet.py``).

Layout ``[B, T, C]``. The residual stack runs K1, the hand-written CUDA
residual block (``csrc/wavenet_block.cu``), two kernels per block:
``residual_gate`` (the dilated k=3 product with bias, conditioner and gate)
and ``residual_out`` (the output product with the residual update and the
skip sum). ``residual_gate_reference`` and ``residual_out_reference`` are
their plain PyTorch versions, which the wrappers take for CPU tensors. In
float32 both run on the tensor cores through 3xTF32 ``wgmma``; their
weights are split once into TF32 big and small halves in the kernels'
layout (``split_weights``: one launch of K1's split kernel for all of a
call's weights; its plain version ``tf32_split``), which ``prepare`` does
once a sampling call or a training forward, and a direct call without them
does itself.

Training goes through ``ResidualBlockFunction`` whenever grad is enabled:
its forward is ``residual_gate_train`` (K1's gate in its training mode,
which also writes the pre-activation z) and ``residual_out``; its backward
is K1's backward, ``residual_gate_backward`` (dz from dx', dskip' and z:
3xTF32 ``wgmma``, on W_out split as stored, which ``prepare`` adds under
grad), ``residual_input_backward`` (dx and the step's gradient from dz)
and ``residual_weight_grad`` (dW_conv and dW_out in one launch), each with
its plain version beside it (``*_reference``). The input backward and the
weight gradients run on the 3xTF32 ``mma.sync`` core
(``csrc/tf32x3.cuh``). Serving (grad disabled) keeps ``residual_block``.

The per-block conditioner projections ``[B, T, 2R]`` are constant across
the reverse-diffusion steps, so ``prepare`` computes them once per sampling
call (the JAX ``project_conditioner`` hoist), together with the blocks'
weights packed in the layout the kernel reads and their split; one list
entry a block, so that training takes the same path.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from ..registry import DENOISERS
from .common import ConvNorm, LinearNorm, diffusion_embedding, mish, shift_time

_RSQRT2 = 1.0 / math.sqrt(2.0)


def _round_tf32(x):
    """x to TF32 (10 mantissa bits), to nearest with ties away from zero, as
    float32: ``tf32x3::round_tf32``'s two integer operations."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(w):
    """The forward kernels' weights (``csrc/wavenet_block.cu``, ``k1f``):
    w [K, N] float32 -> [2, N, K], w's transpose (K-major) as big = rna(w)
    and small = rna(w - big) (``tf32x3::split``). No gradient flows
    through it."""
    t = w.detach().t()
    big = _round_tf32(t)
    return torch.stack([big, _round_tf32(t - big)])


def split_weights_reference(ws, transposed, stored):
    """Plain version of K1's split kernel: for each weight w [K, N], its
    ``tf32_split(w)`` ([2, N, K]) where ``transposed[i]`` and its
    ``tf32_split(w.t())`` (w itself split, [2, K, N]: the gate backward's
    W_out) where ``stored[i]`` -> (the transposed splits, the stored ones),
    None where not asked."""
    return ([tf32_split(w) if t else None for w, t in zip(ws, transposed)],
            [tf32_split(w.t()) if n else None for w, n in zip(ws, stored)])


def split_weights(ws, transposed, stored):
    """K1's split kernel, ``csrc/wavenet_block.cu`` ``wavenet_weight_split``:
    the float32 weights ``ws`` (at most 64) split as
    ``split_weights_reference`` does, bit for bit, in one launch that reads
    each weight once, also where it writes both layouts. CPU tensors take
    ``split_weights_reference``."""
    if not ws[0].is_cuda:
        return split_weights_reference(ws, transposed, stored)
    kernels.require_cuda("split_weights", *ws)
    _check_f32("split_weights", ws[0])

    def planes(asked, shape):
        return [torch.empty((2, *shape(w)), dtype=w.dtype, device=w.device) if a else None
                for w, a in zip(ws, asked)]

    out_t = planes(transposed, lambda w: w.shape[::-1])
    out_n = planes(stored, lambda w: w.shape)
    n = len(ws)

    def pointers(ts):
        return (ctypes.c_void_p * n)(*(None if t is None else t.data_ptr() for t in ts))

    kernels.check(
        kernels.load_library("wavenet_block").wavenet_weight_split(
            pointers(ws), pointers(out_t), pointers(out_n),
            (ctypes.c_int * n)(*(w.shape[0] for w in ws)),
            (ctypes.c_int * n)(*(w.shape[1] for w in ws)), n, kernels.stream(),
        ),
        "wavenet_weight_split",
    )
    kernels.count_launch("wavenet_weight_split")
    return out_t, out_n


def gate_preactivation_reference(x, step, cond, w_conv, b_conv, dilation: int):
    """K1's pre-activation z [B, T, 2R]: the dilated k=3 product of
    y = x + step[b] (zero outside [0, T)) with bias and conditioner."""
    R = x.shape[-1]
    y = x + step[:, None, :]
    z = (
        shift_time(y, dilation) @ w_conv[:R]
        + y @ w_conv[R : 2 * R]
        + shift_time(y, -dilation) @ w_conv[2 * R :]
    )
    z = z + b_conv
    return z + cond


def _gate(z):
    gate, filt = z.chunk(2, dim=-1)
    return torch.sigmoid(gate) * torch.tanh(filt)


def residual_gate_reference(x, step, cond, w_conv, b_conv, dilation: int, w_split=None):
    """Plain version of K1's first kernel. x [B, T, R]; step [B, R]; cond
    [B, T, 2R]; w_conv [3R, 2R] (taps x[t-d], x[t], x[t+d] stacked on the
    input axis); b_conv [2R] -> g [B, T, R]. ``w_split``, which the kernel
    reads, is not used."""
    return _gate(gate_preactivation_reference(x, step, cond, w_conv, b_conv, dilation))


def residual_gate_train_reference(x, step, cond, w_conv, b_conv, dilation: int,
                                  w_split=None):
    """Plain version of K1's gate in its training mode -> (g, z)."""
    z = gate_preactivation_reference(x, step, cond, w_conv, b_conv, dilation)
    return _gate(z), z


def residual_out_reference(g, x, skip, w_out, b_out, w_split=None):
    """Plain version of K1's second kernel. g, x, skip [B, T, R]; w_out
    [R, 2R]; b_out [2R] -> (x', skip') (``w_split`` not used)."""
    out = g @ w_out + b_out
    res, skip_add = out.chunk(2, dim=-1)
    return (x + res) * _RSQRT2, skip + skip_add


def residual_block_reference(x, skip, step, cond, w_conv, b_conv, w_out, b_out,
                             dilation: int, conv_split=None, out_split=None):
    """Plain version of K1: one residual block -> (x', skip') (the split
    weights not used)."""
    g = residual_gate_reference(x, step, cond, w_conv, b_conv, dilation)
    return residual_out_reference(g, x, skip, w_out, b_out)


def _check_shapes(name, shapes: dict, R: int, *tensors):
    for arg, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} != {shape}")
    if R % 64:
        raise ValueError(f"{name}: channels {R} not a multiple of 64")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _split_for(name, w, w_split, R: int, transpose: bool = True):
    """The split weights a float32 launch reads: ``w_split`` checked
    (``[2, *w.shape]``, transposed where ``transpose``), or
    ``split_weights`` made here (a call without ``prepare``'s); None for
    bfloat16 (its kernel reads w)."""
    if w.dtype != torch.float32:
        return None
    if w_split is None:
        split_t, split_n = split_weights([w], [transpose], [not transpose])
        return (split_t if transpose else split_n)[0]
    kernels.require_cuda(name, w, w_split)
    shape = (2, *(w.shape[::-1] if transpose else w.shape))
    _check_shapes(name, {"w_split": (w_split, shape)}, R, w_split)
    return w_split


def _ptr(t):
    return None if t is None else t.data_ptr()


def _taps_scratch(w_split, B: int, R: int):
    """The float32 gate's scratch for step[b] W_tap, [B, 3, 2R] (None for
    bfloat16)."""
    if w_split is None:
        return None
    return torch.empty((B, 3, 2 * R), dtype=torch.float32, device=w_split.device)


def residual_gate(x, step, cond, w_conv, b_conv, dilation: int, w_split=None):
    """K1, first kernel: the dilated k=3 product with bias, conditioner and
    gate; ``w_split = tf32_split(w_conv)``, made here if not given. CPU
    tensors take ``residual_gate_reference``."""
    if not x.is_cuda:
        return residual_gate_reference(x, step, cond, w_conv, b_conv, dilation)
    kernels.require_cuda("residual_gate", x, step, cond, w_conv, b_conv)
    B, T, R = x.shape
    _check_shapes("residual_gate", {
        "step": (step, (B, R)), "cond": (cond, (B, T, 2 * R)),
        "w_conv": (w_conv, (3 * R, 2 * R)), "b_conv": (b_conv, (2 * R,)),
    }, R, x, step, cond, w_conv, b_conv)
    w_split = _split_for("residual_gate", w_conv, w_split, R)
    g = torch.empty_like(x)
    taps = _taps_scratch(w_split, B, R)
    kernels.check(
        kernels.load_library("wavenet_block").wavenet_gate(
            kernels.dtype_code(x), x.data_ptr(), step.data_ptr(),
            w_conv.data_ptr(), _ptr(w_split), _ptr(taps), b_conv.data_ptr(), cond.data_ptr(),
            g.data_ptr(), B, T, R, R, int(dilation), kernels.stream(),
        ),
        "wavenet_gate",
    )
    kernels.count_launch("wavenet_gate")
    return g


def residual_out(g, x, skip, w_out, b_out, w_split=None):
    """K1, second kernel: the output product with the residual update and
    the skip sum; ``w_split = tf32_split(w_out)``, made here if not given.
    CPU tensors take ``residual_out_reference``."""
    if not g.is_cuda:
        return residual_out_reference(g, x, skip, w_out, b_out)
    kernels.require_cuda("residual_out", g, x, skip, w_out, b_out)
    B, T, R = x.shape
    _check_shapes("residual_out", {
        "g": (g, (B, T, R)), "skip": (skip, (B, T, R)),
        "w_out": (w_out, (R, 2 * R)), "b_out": (b_out, (2 * R,)),
    }, R, g, x, skip, w_out, b_out)
    w_split = _split_for("residual_out", w_out, w_split, R)
    x_out, skip_out = torch.empty_like(x), torch.empty_like(skip)
    kernels.check(
        kernels.load_library("wavenet_block").wavenet_out(
            kernels.dtype_code(x), g.data_ptr(), w_out.data_ptr(), _ptr(w_split),
            b_out.data_ptr(), x.data_ptr(), skip.data_ptr(), x_out.data_ptr(),
            skip_out.data_ptr(), B, T, R, kernels.stream(),
        ),
        "wavenet_out",
    )
    kernels.count_launch("wavenet_out")
    return x_out, skip_out


def residual_block(x, skip, step, cond, w_conv, b_conv, w_out, b_out,
                   dilation: int, conv_split=None, out_split=None):
    """K1: one residual block -> (x', skip')."""
    g = residual_gate(x, step, cond, w_conv, b_conv, dilation, conv_split)
    return residual_out(g, x, skip, w_out, b_out, out_split)


def residual_gate_train(x, step, cond, w_conv, b_conv, dilation: int, w_split=None):
    """K1's gate in its training mode (float32): ``residual_gate`` that also
    returns the pre-activation z [B, T, 2R] -> (g, z), on the same plan
    for the same shapes. CPU tensors take
    ``residual_gate_train_reference``."""
    if not x.is_cuda:
        return residual_gate_train_reference(x, step, cond, w_conv, b_conv, dilation)
    kernels.require_cuda("residual_gate_train", x, step, cond, w_conv, b_conv)
    _check_f32("residual_gate_train", x)
    B, T, R = x.shape
    _check_shapes("residual_gate_train", {
        "step": (step, (B, R)), "cond": (cond, (B, T, 2 * R)),
        "w_conv": (w_conv, (3 * R, 2 * R)), "b_conv": (b_conv, (2 * R,)),
    }, R, x, step, cond, w_conv, b_conv)
    w_split = _split_for("residual_gate_train", w_conv, w_split, R)
    g = torch.empty_like(x)
    z = torch.empty_like(cond)
    taps = _taps_scratch(w_split, B, R)
    kernels.check(
        kernels.load_library("wavenet_block").wavenet_gate_train(
            x.data_ptr(), step.data_ptr(), w_conv.data_ptr(), w_split.data_ptr(),
            taps.data_ptr(), b_conv.data_ptr(), cond.data_ptr(), g.data_ptr(), z.data_ptr(),
            B, T, R, int(dilation), kernels.stream(),
        ),
        "wavenet_gate_train",
    )
    kernels.count_launch("wavenet_gate_train")
    return g, z


def _check_f32(name, t):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: takes float32, got {t.dtype}")


def residual_gate_backward_reference(dx_out, dskip_out, z, w_out, w_split=None):
    """Plain version of K1's gate backward: dx', dskip' [B, T, R], z
    [B, T, 2R], w_out [R, 2R] -> dz [B, T, 2R] through the output product
    (do = [dx' / sqrt(2) | dskip']) and the gate (``w_split`` not used)."""
    do = torch.cat([dx_out * _RSQRT2, dskip_out], dim=-1)
    dg = do @ w_out.t()
    s, tf = torch.sigmoid(z[..., : dg.shape[-1]]), torch.tanh(z[..., dg.shape[-1] :])
    return torch.cat([dg * tf * s * (1 - s), dg * s * (1 - tf * tf)], dim=-1)


def residual_gate_backward(dx_out, dskip_out, z, w_out, w_split=None):
    """K1's gate backward, ``csrc/wavenet_block.cu`` ``wavenet_gate_backward``,
    on the 3xTF32 ``wgmma`` core in the plan its rule picks from B T; its
    weights ``w_split`` are W_out split as stored (``split_weights``'
    ``stored`` layout, [2, R, 2R]: ``prepare``'s ``bwd_split``), made
    here if not given (see ``residual_gate_backward_reference``, which CPU
    tensors take)."""
    if not dx_out.is_cuda:
        return residual_gate_backward_reference(dx_out, dskip_out, z, w_out)
    kernels.require_cuda("residual_gate_backward", dx_out, dskip_out, z, w_out)
    _check_f32("residual_gate_backward", dx_out)
    B, T, R = dx_out.shape
    _check_shapes("residual_gate_backward", {
        "dskip_out": (dskip_out, (B, T, R)), "z": (z, (B, T, 2 * R)),
        "w_out": (w_out, (R, 2 * R)),
    }, R, dx_out, dskip_out, z, w_out)
    w_split = _split_for("residual_gate_backward", w_out, w_split, R, transpose=False)
    dz = torch.empty_like(z)
    kernels.check(
        kernels.load_library("wavenet_block").wavenet_gate_backward(
            dx_out.data_ptr(), dskip_out.data_ptr(), w_split.data_ptr(), z.data_ptr(),
            dz.data_ptr(), B, T, R, kernels.stream(),
        ),
        "wavenet_gate_backward",
    )
    kernels.count_launch("wavenet_gate_backward")
    return dz


def residual_input_backward_reference(dz, dx_out, w_conv, dilation: int):
    """Plain version of K1's input backward: dz [B, T, 2R], dx' [B, T, R],
    w_conv [3R, 2R] -> (dx [B, T, R], ds [B, R]) with
    dy[t] = dz[t+d] W_l^T + dz[t] W_c^T + dz[t-d] W_r^T (zero outside
    [0, T)), dx = dx' / sqrt(2) + dy and ds = sum_t dy."""
    R = dx_out.shape[-1]
    dy = (
        shift_time(dz, -dilation) @ w_conv[:R].t()
        + dz @ w_conv[R : 2 * R].t()
        + shift_time(dz, dilation) @ w_conv[2 * R :].t()
    )
    return dx_out * _RSQRT2 + dy, dy.sum(dim=1)


def residual_input_backward(dz, dx_out, w_conv, dilation: int):
    """K1's input backward, ``csrc/wavenet_block.cu`` ``wavenet_input_backward``:
    dx, and ds as the kernel's per-tile column sums added in order (see
    ``residual_input_backward_reference``, which CPU tensors take)."""
    if not dz.is_cuda:
        return residual_input_backward_reference(dz, dx_out, w_conv, dilation)
    kernels.require_cuda("residual_input_backward", dz, dx_out, w_conv)
    _check_f32("residual_input_backward", dz)
    B, T, R = dx_out.shape
    _check_shapes("residual_input_backward", {
        "dz": (dz, (B, T, 2 * R)), "w_conv": (w_conv, (3 * R, 2 * R)),
    }, R, dz, dx_out, w_conv)
    lib = kernels.load_library("wavenet_block")
    rows = lib.wavenet_backward_rows(B, T, R)
    dx = torch.empty_like(dx_out)
    part = torch.empty((B, -(-T // rows), R), dtype=dz.dtype, device=dz.device)
    kernels.check(
        lib.wavenet_input_backward(
            dz.data_ptr(), dx_out.data_ptr(), w_conv.data_ptr(), dx.data_ptr(),
            part.data_ptr(), B, T, R, int(dilation), kernels.stream(),
        ),
        "wavenet_input_backward",
    )
    kernels.count_launch("wavenet_input_backward")
    return dx, part.sum(dim=1)


def residual_weight_grad_reference(y, dz, g, dx_out, dskip_out, dilation: int):
    """Plain version of K1's weight gradients: y = x + step[b], g, dx',
    dskip' [B, T, R], dz [B, T, 2R] -> (dW_conv [3R, 2R], dW_out [R, 2R])
    with dW_conv's tap blocks the products of y[t - d], y[t], y[t + d] (zero
    outside [0, T)) with dz, and dW_out = g^T do, do = [dx' / sqrt(2) | dskip']."""
    R = y.shape[-1]
    dz2 = dz.reshape(-1, 2 * R)
    taps = (shift_time(y, dilation), y, shift_time(y, -dilation))
    dw_conv = torch.cat([a.reshape(-1, R).t() @ dz2 for a in taps])
    do = torch.cat([dx_out * _RSQRT2, dskip_out], dim=-1)
    return dw_conv, g.reshape(-1, R).t() @ do.reshape(-1, 2 * R)


def residual_weight_grad(y, dz, g, dx_out, dskip_out, dilation: int):
    """K1's weight gradients, ``csrc/wavenet_block.cu`` ``wavenet_weight_grad``
    (both products in one launch on the 3xTF32 tensor-core core, the rows cut
    into chunks whose partial tiles are added in chunk order; see
    ``residual_weight_grad_reference``, which CPU tensors take)."""
    if not y.is_cuda:
        return residual_weight_grad_reference(y, dz, g, dx_out, dskip_out, dilation)
    kernels.require_cuda("residual_weight_grad", y, dz, g, dx_out, dskip_out)
    _check_f32("residual_weight_grad", y)
    B, T, R = y.shape
    _check_shapes("residual_weight_grad", {
        "dz": (dz, (B, T, 2 * R)), "g": (g, (B, T, R)), "dx_out": (dx_out, (B, T, R)),
        "dskip_out": (dskip_out, (B, T, R)),
    }, R, y, dz, g, dx_out, dskip_out)
    lib = kernels.load_library("wavenet_block")
    chunks = lib.wavenet_weight_grad_chunks(B, T, R)
    part = torch.empty((chunks, 4 * R, 2 * R), dtype=y.dtype, device=y.device)
    dw_conv = torch.empty((3 * R, 2 * R), dtype=y.dtype, device=y.device)
    dw_out = torch.empty((R, 2 * R), dtype=y.dtype, device=y.device)
    kernels.check(
        lib.wavenet_weight_grad(
            y.data_ptr(), dz.data_ptr(), g.data_ptr(), dx_out.data_ptr(),
            dskip_out.data_ptr(), part.data_ptr(), dw_conv.data_ptr(), dw_out.data_ptr(),
            B, T, R, int(dilation), chunks, kernels.stream(),
        ),
        "wavenet_weight_grad",
    )
    kernels.count_launch("wavenet_weight_grad")
    return dw_conv, dw_out


def residual_block_backward(x, step, z, g, dx_out, dskip_out, w_conv, w_out,
                            dilation: int, bwd_split=None):
    """K1's backward: the gradients of (x, skip, step, cond, w_conv, b_conv,
    w_out, b_out) from those of (x', skip'). dz, dx and the weight gradients
    come from K1's backward kernels (``residual_gate_backward`` on
    ``bwd_split``, ``residual_input_backward``, ``residual_weight_grad`` on
    y = x + step[b], rebuilt); the bias gradients are column sums."""
    dx_out, dskip_out = dx_out.contiguous(), dskip_out.contiguous()
    dz = residual_gate_backward(dx_out, dskip_out, z, w_out, bwd_split)
    dx, ds = residual_input_backward(dz, dx_out, w_conv, dilation)
    dw_conv, dw_out = residual_weight_grad(x + step[:, None, :], dz, g, dx_out, dskip_out,
                                           dilation)
    db_out = torch.cat([(dx_out * _RSQRT2).sum(dim=(0, 1)), dskip_out.sum(dim=(0, 1))])
    return dx, dskip_out, ds, dz, dw_conv, dz.sum(dim=(0, 1)), dw_out, db_out


class ResidualBlockFunction(torch.autograd.Function):
    """K1 with a gradient: (x, skip, step, cond, w_conv, b_conv, w_out,
    b_out, dilation, conv_split, out_split, bwd_split) -> (x', skip'). The
    kernels read the split weights (``split_weights``: made where needed
    when None), which take no gradient; the weight gradients go to w_conv
    and w_out. The forward saves x, step, z and g (~4 activations of [B, T,
    R] a block); the backward is ``residual_block_backward``."""

    @staticmethod
    def forward(ctx, x, skip, step, cond, w_conv, b_conv, w_out, b_out, dilation,
                conv_split=None, out_split=None, bwd_split=None):
        g, z = residual_gate_train(x, step, cond, w_conv, b_conv, dilation, conv_split)
        x_out, skip_out = residual_out(g, x, skip, w_out, b_out, out_split)
        ctx.save_for_backward(x, step, z, g, w_conv, w_out, bwd_split)
        ctx.dilation = dilation
        return x_out, skip_out

    @staticmethod
    def backward(ctx, dx_out, dskip_out):
        x, step, z, g, w_conv, w_out, bwd_split = ctx.saved_tensors
        grads = residual_block_backward(x, step, z, g, dx_out, dskip_out, w_conv,
                                        w_out, ctx.dilation, bwd_split)
        return (*grads, None, None, None, None)


def residual_block_train(x, skip, step, cond, w_conv, b_conv, w_out, b_out,
                         dilation: int, conv_split=None, out_split=None, bwd_split=None):
    """K1 with its backward: one residual block -> (x', skip')."""
    return ResidualBlockFunction.apply(x, skip, step, cond, w_conv, b_conv, w_out,
                                       b_out, dilation, conv_split, out_split, bwd_split)


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class DilatedConv(nn.Module):
    """Parameter holder of the k=3 dilated conv (key ``conv``,
    ``[2R, R, 3]``); tap 0 reads x[t-d]. The compute is K1."""

    def __init__(self, channels: int, out_channels: int, dilation: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, out_channels, 3, padding=dilation,
                              dilation=dilation)


class ResidualBlock(nn.Module):
    def __init__(self, d_encoder: int, residual_channels: int, dilation: int,
                 use_linear_bias: bool):
        super().__init__()
        r = residual_channels
        self.dilation = dilation
        self.diffusion_projection = LinearNorm(r, r, use_linear_bias)
        self.conv_layer = DilatedConv(r, 2 * r, dilation)
        self.conditioner_projection = ConvNorm(d_encoder, 2 * r)
        self.output_projection = ConvNorm(r, 2 * r)


@DENOISERS.register_module(name="WaveNetDenoiser")
class WaveNet(nn.Module):
    """x [B, T, mel_channels], diffusion_step [B], conditioner [B, T, d_encoder]
    -> noise estimate [B, T, mel_channels] (float32)."""

    def __init__(
        self,
        mel_channels: int = 128,
        d_encoder: int = 256,
        residual_channels: int = 512,
        residual_layers: int = 20,
        use_linear_bias: bool = False,
        dilation_cycle: Optional[int] = None,
    ):
        super().__init__()
        r = residual_channels
        self.residual_channels = r
        self.input_projection = ConvNorm(mel_channels, r)
        self.mlp = nn.Sequential(
            LinearNorm(r, 4 * r, use_linear_bias),
            Mish(),
            LinearNorm(4 * r, r, use_linear_bias),
        )
        self.residual_layers = nn.ModuleList(
            ResidualBlock(
                d_encoder,
                r,
                2 ** (i % dilation_cycle) if dilation_cycle else 1,
                use_linear_bias,
            )
            for i in range(residual_layers)
        )
        self.skip_projection = ConvNorm(r, r)
        self.output_projection = ConvNorm(r, mel_channels)

    @staticmethod
    def _conditioner(conditioner, cond_masks):
        c = conditioner.float()
        if cond_masks is not None:
            c = c.masked_fill(cond_masks[:, :, None], 0.0)
        return c

    def prepare(self, conditioner: torch.Tensor,
                cond_masks: Optional[torch.Tensor] = None) -> dict:
        """Per-sampling-call constants, one entry a block: ``cond``, the
        block's conditioner projection ``[B, T, 2R]``, and its weights packed
        in the layout the kernel reads (``w_conv [3R, 2R]``, ``b_conv``,
        ``w_out [R, 2R]``, ``b_out``) with the float32 kernels' split of them
        (``conv_split``, ``out_split``: transposed, ~16 MB a block at R =
        512; under grad also ``bwd_split``, W_out split as stored for the
        gate backward, 4 MB; None for other dtypes or without grad), all in
        one ``split_weights`` call, made from the live parameters on every
        call, so that the forward after an optimizer step reads the new
        weights. Lists, not stacks, so that under grad each block's gradient
        is its own."""
        c = self._conditioner(conditioner, cond_masks)
        r = self.residual_channels
        layers = self.residual_layers
        n = len(layers)
        w_conv = [layer.conv_layer.conv.weight.permute(2, 1, 0).reshape(3 * r, 2 * r)
                  .contiguous() for layer in layers]
        w_out = [layer.output_projection.conv.weight[:, :, 0].t().contiguous()
                 for layer in layers]
        split_t = split_n = [None] * (2 * n)
        if w_conv[0].dtype == torch.float32:
            split_t, split_n = split_weights(w_conv + w_out, [True] * (2 * n),
                                             [False] * n + [torch.is_grad_enabled()] * n)
        return {
            "cond": [F.linear(c, layer.conditioner_projection.conv.weight[:, :, 0],
                              layer.conditioner_projection.conv.bias) for layer in layers],
            "w_conv": w_conv,
            "b_conv": [layer.conv_layer.conv.bias for layer in layers],
            "w_out": w_out,
            "b_out": [layer.output_projection.conv.bias for layer in layers],
            "conv_split": split_t[:n],
            "out_split": split_t[n:],
            "bwd_split": split_n[n:],
        }

    def forward(
        self,
        x: torch.Tensor,
        diffusion_step: torch.Tensor,
        conditioner: Optional[torch.Tensor],
        x_masks: Optional[torch.Tensor] = None,
        cond_masks: Optional[torch.Tensor] = None,
        plan: Optional[dict] = None,
    ) -> torch.Tensor:
        """With grad enabled (training) each block runs K1 with its backward
        (``residual_block_train``), else K1 (``residual_block``)."""
        plan = plan or self.prepare(conditioner, cond_masks)
        x = F.relu(self.input_projection(x.float()))
        step = self.mlp(diffusion_embedding(diffusion_step, self.residual_channels))
        if x_masks is not None:
            x = x.masked_fill(x_masks[:, :, None], 0.0)

        skip = torch.zeros_like(x)
        grad = torch.is_grad_enabled()
        for layer, cond, w_conv, b_conv, w_out, b_out, conv_split, out_split, bwd_split in zip(
            self.residual_layers, plan["cond"], plan["w_conv"], plan["b_conv"], plan["w_out"],
            plan["b_out"], plan["conv_split"], plan["out_split"], plan["bwd_split"],
        ):
            args = (x, skip, layer.diffusion_projection(step), cond, w_conv, b_conv, w_out,
                    b_out, layer.dilation, conv_split, out_split)
            x, skip = residual_block_train(*args, bwd_split) if grad else residual_block(*args)

        x = skip * (1.0 / math.sqrt(len(self.residual_layers)))
        x = F.relu(self.skip_projection(x))
        x = self.output_projection(x)
        if x_masks is not None:
            x = x.masked_fill(x_masks[:, :, None], 0.0)
        return x.float()
