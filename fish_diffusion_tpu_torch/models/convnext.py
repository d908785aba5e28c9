"""ConvNeXt denoiser (``fish_diffusion_tpu/models/convnext.py:ConvNext``).

Layout ``[B, T, C]``. Each block runs K10, the hand-written CUDA kernel
``csrc/convnext_block.cu``: the pre-add of the block's step and condition
projections, the padding mask, the 7-tap dilated depthwise conv with its
bias and the LayerNorm (eps 1e-6) in one pass (``depthwise_conv7_norm``).
``depthwise_conv7_norm_reference`` is its plain PyTorch version, which the
wrapper takes for CPU tensors. The pointwise MLP (``pwconv1``, exact GELU,
``pwconv2``), the layer scale ``gamma``, the residual and the mask stay
plain PyTorch (the projections are cuBLAS products, as the JAX package
leaves its ``nn.Dense`` to XLA).

Training: with grad enabled ``depthwise_conv7_norm`` goes through
``DepthwiseConv7NormFunction``, whose forward is the serving kernel and
whose backward is K10's backward, two kernels of the same source:
``depthwise_conv7_norm_backward_rows`` (the norm's backward: dh, and the
gradients of the conv's taps and bias and of the norm's scale and bias)
and ``depthwise_conv7_backward_taps`` (the taps transposed: the pre-add's
gradient, which is x's and cond's, and the step's). Each has its plain
version beside it (``*_reference``), which CPU tensors take.

The per-block condition projections ``[B, T, C]`` and the depthwise
kernels in the layout K10 reads ``[7, C]`` are constant across the
reverse-diffusion steps, so ``prepare`` computes them once per sampling
call (and once per forward in training, where each block's gradient
flows back through its own entry). Module and parameter names are fish-diffusion's torch layout, which
``tools/diffusion/convert_torch_checkpoint.py:convert_convnext`` reads.

Not ported: the interleaved cross-attention blocks (``cross_attention``;
ROADMAP Queue 1, "Other denoisers"; no config sets it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from ..registry import DENOISERS
from .common import diffusion_embedding, shift_time

LN_EPS = 1e-6
TAPS = 7
# K10 keeps a tile of ROWS rows x C channels of the conv's output in shared
# memory, with THREADS + 2 * ROWS floats for the row statistics; its
# backward (kernel A) two such tiles and THREADS + 4 * ROWS floats
_ROWS, _THREADS, _SMEM_LIMIT = 16, 256, 232448
MAX_CHANNELS = (_SMEM_LIMIT // 4 - _THREADS - 2 * _ROWS) // _ROWS
MAX_TRAIN_CHANNELS = (_SMEM_LIMIT // 4 - _THREADS - 4 * _ROWS) // (2 * _ROWS)
# kernel A's column partials a tile: dln_scale, dln_bias, db, dk[0..6]
_PARTS = 3 + TAPS


def _pre_add(x, step, cond, mask):
    """y = x + step + cond, 0 at padding."""
    y = x + step[:, None, :] + cond
    return y if mask is None else y.masked_fill(mask[:, :, None], 0.0)


def _conv7(y, k, b, dilation: int):
    """h[t, c] = b[c] + sum_j k[j, c] y[t + (j - 3) d, c] (0 outside [0, T))."""
    return b + sum(k[j] * shift_time(y, -(j - 3) * dilation) for j in range(TAPS))


def depthwise_conv7_norm_reference(x, step, cond, mask, k, b, ln_scale, ln_bias,
                                   dilation: int):
    """Plain version of K10. x, cond [B, T, C]; step [B, C]; mask [B, T]
    (True at padding) or None; k [7, C]; b, ln_scale, ln_bias [C] ->
    LayerNorm over C (eps 1e-6) of h [B, T, C] with
    y[t] = 0 if mask[t] else x[t] + step + cond[t] (0 outside [0, T)) and
    h[t, c] = b[c] + sum_j k[j, c] y[t + (j - 3) d, c]."""
    h = _conv7(_pre_add(x, step, cond, mask), k, b, dilation)
    return F.layer_norm(h, (h.shape[-1],), ln_scale, ln_bias, LN_EPS)


def depthwise_conv7_norm_backward_rows_reference(go, x, step, cond, mask, k, b, ln_scale,
                                                 dilation: int):
    """Plain version of K10's norm backward: go = dL/dout [B, T, C] and the
    forward's inputs -> (dh [B, T, C], dk [7, C], db, dln_scale, dln_bias
    [C]) with n = (h - mean) r, r = 1 / sqrt(var + eps), g = go * scale:
    dh = r (g - mean_C(g) - n mean_C(g n)), dk[j] = sum dh[t] y[t + (j-3) d]."""
    y = _pre_add(x, step, cond, mask)
    h = _conv7(y, k, b, dilation)
    mean = h.mean(-1, keepdim=True)
    r = torch.rsqrt((h - mean).square().mean(-1, keepdim=True) + LN_EPS)
    n = (h - mean) * r
    g = go * ln_scale
    dh = r * (g - g.mean(-1, keepdim=True) - n * (g * n).mean(-1, keepdim=True))
    dk = torch.stack([(dh * shift_time(y, -(j - 3) * dilation)).sum((0, 1))
                      for j in range(TAPS)])
    return dh, dk, dh.sum((0, 1)), (go * n).sum((0, 1)), go.sum((0, 1))


def depthwise_conv7_backward_taps_reference(dh, mask, k, dilation: int):
    """Plain version of K10's taps backward: dh [B, T, C] -> (dy [B, T, C],
    dstep [B, C]) with dy[t] = sum_j k[j] dh[t - (j - 3) d] (dh 0 outside
    [0, T)), 0 at padding (the mask applies to the source row only), and
    dstep = sum_t dy."""
    dy = sum(k[j] * shift_time(dh, (j - 3) * dilation) for j in range(TAPS))
    if mask is not None:
        dy = dy.masked_fill(mask[:, :, None], 0.0)
    return dy, dy.sum(1)


def depthwise_conv7_norm_backward_reference(go, x, step, cond, mask, k, b, ln_scale,
                                            ln_bias, dilation: int):
    """Plain version of K10's backward: the gradients (dx, dstep, dcond, dk,
    db, dln_scale, dln_bias) of ``depthwise_conv7_norm_reference`` given
    go; dx and dcond are one tensor (the pre-add's gradient)."""
    dh, dk, db, dw, dlb = depthwise_conv7_norm_backward_rows_reference(
        go, x, step, cond, mask, k, b, ln_scale, dilation)
    dy, dstep = depthwise_conv7_backward_taps_reference(dh, mask, k, dilation)
    return dy, dstep, dy, dk, db, dw, dlb


def _check(name, x, step, cond, mask, k, vectors, max_channels):
    """The wrappers' argument checks: float32 CUDA tensors of K10's shapes."""
    kernels.require_cuda(name, x, step, cond, k, *vectors)
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: takes float32, got {x.dtype}")
    B, T, C = x.shape
    for label, t, shape in (("step", step, (B, C)), ("cond", cond, (B, T, C)),
                            ("k", k, (TAPS, C))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} {tuple(t.shape)} != {shape}")
    for t in vectors:
        if tuple(t.shape) != (C,):
            raise ValueError(f"{name}: a per-channel vector {tuple(t.shape)} != {(C,)}")
    if C > max_channels:
        raise ValueError(f"{name}: {C} channels > {max_channels}")
    _check_mask(name, mask, x)


def _check_mask(name, mask, x):
    if mask is not None and (mask.dtype != torch.bool or mask.shape != x.shape[:2]
                             or mask.device != x.device or not mask.is_contiguous()):
        raise ValueError(f"{name}: mask must be a contiguous bool [B, T] tensor on the "
                         "input's device")


def depthwise_conv7_norm(x, step, cond, mask, k, b, ln_scale, ln_bias, dilation: int):
    """K10: ``csrc/convnext_block.cu`` ``depthwise_conv7_norm`` (see
    ``depthwise_conv7_norm_reference``, which CPU tensors take). float32;
    any T and dilation, C up to ``MAX_CHANNELS``. With grad enabled and an
    input that requires it, ``DepthwiseConv7NormFunction`` (this kernel,
    with K10's backward)."""
    tensors = (x, step, cond, k, b, ln_scale, ln_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return DepthwiseConv7NormFunction.apply(x, step, cond, mask, k, b, ln_scale, ln_bias,
                                                dilation)
    if not x.is_cuda:
        return depthwise_conv7_norm_reference(x, step, cond, mask, k, b, ln_scale,
                                              ln_bias, dilation)
    _check("depthwise_conv7_norm", x, step, cond, mask, k, (b, ln_scale, ln_bias),
           MAX_CHANNELS)
    if dilation < 1:
        raise ValueError(f"depthwise_conv7_norm: dilation {dilation} < 1")
    B, T, C = x.shape
    out = torch.empty_like(x)
    kernels.check(
        kernels.load_library("convnext_block").depthwise_conv7_norm(
            x.data_ptr(), step.data_ptr(), cond.data_ptr(),
            None if mask is None else mask.data_ptr(), k.data_ptr(), b.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), out.data_ptr(), B, T, C,
            int(dilation), LN_EPS, kernels.stream(),
        ),
        "depthwise_conv7_norm",
    )
    kernels.count_launch("depthwise_conv7_norm")
    return out


# The backward's per-tile partial sums, one buffer per device grown to the
# largest call (a training step's: 640 tiles x 11 x 512 floats, 14 MB).
# Calls on one stream use it in turn: each call's sums are read before the
# next call's kernels write it.
_PARTIALS: dict = {}


def _partials(tiles: int, C: int, device) -> tuple:
    """Views [tiles, 10, C] (kernel A's) and [tiles, C] (kernel B's) of the
    module's partial-sum buffer on ``device``."""
    n = tiles * (_PARTS + 1) * C
    buf = _PARTIALS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=device)
        _PARTIALS[device] = buf
    a = buf[: tiles * _PARTS * C].view(tiles, _PARTS, C)
    return a, buf[tiles * _PARTS * C : n].view(tiles, C)


def depthwise_conv7_norm_backward_rows(go, x, step, cond, mask, k, b, ln_scale,
                                       dilation: int):
    """K10's norm backward, kernel A, ``csrc/convnext_block.cu``
    ``depthwise_conv7_norm_backward_rows``: dh and the tiles' column
    partials of dk, db, dln_scale and dln_bias, added over the tiles in an
    order fixed by the shapes (see
    ``depthwise_conv7_norm_backward_rows_reference``, which CPU tensors
    take). C up to ``MAX_TRAIN_CHANNELS``."""
    if not go.is_cuda:
        return depthwise_conv7_norm_backward_rows_reference(go, x, step, cond, mask, k, b,
                                                            ln_scale, dilation)
    _check("depthwise_conv7_norm_backward_rows", x, step, cond, mask, k, (b, ln_scale),
           MAX_TRAIN_CHANNELS)
    kernels.require_cuda("depthwise_conv7_norm_backward_rows", go, x)
    if go.shape != x.shape:
        raise ValueError(f"depthwise_conv7_norm_backward_rows: go {tuple(go.shape)} != "
                         f"{tuple(x.shape)}")
    B, T, C = x.shape
    lib = kernels.load_library("convnext_block")
    part, _ = _partials(B * lib.depthwise_conv7_backward_tiles(T, int(dilation)), C, x.device)
    dh = torch.empty_like(x)
    kernels.check(
        lib.depthwise_conv7_norm_backward_rows(
            go.data_ptr(), x.data_ptr(), step.data_ptr(), cond.data_ptr(),
            None if mask is None else mask.data_ptr(), k.data_ptr(), b.data_ptr(),
            ln_scale.data_ptr(), dh.data_ptr(), part.data_ptr(), B, T, C, int(dilation),
            LN_EPS, kernels.stream(),
        ),
        "depthwise_conv7_norm_backward_rows",
    )
    kernels.count_launch("depthwise_conv7_norm_backward_rows")
    sums = part.sum(0)
    return dh, sums[3:], sums[2], sums[0], sums[1]


def depthwise_conv7_backward_taps(dh, mask, k, dilation: int):
    """K10's taps backward, kernel B, ``csrc/convnext_block.cu``
    ``depthwise_conv7_backward_taps``: dy, and dstep as the tiles' column
    sums of dy added per item in an order fixed by the shapes (see
    ``depthwise_conv7_backward_taps_reference``, which CPU tensors take)."""
    if not dh.is_cuda:
        return depthwise_conv7_backward_taps_reference(dh, mask, k, dilation)
    B, T, C = dh.shape
    kernels.require_cuda("depthwise_conv7_backward_taps", dh, k)
    if dh.dtype != torch.float32 or tuple(k.shape) != (TAPS, C):
        raise ValueError("depthwise_conv7_backward_taps: float32 dh [B, T, C] and k [7, C]")
    _check_mask("depthwise_conv7_backward_taps", mask, dh)
    lib = kernels.load_library("convnext_block")
    tiles = lib.depthwise_conv7_backward_tiles(T, int(dilation))
    _, part = _partials(B * tiles, C, dh.device)
    dy = torch.empty_like(dh)
    kernels.check(
        lib.depthwise_conv7_backward_taps(
            dh.data_ptr(), None if mask is None else mask.data_ptr(), k.data_ptr(),
            dy.data_ptr(), part.data_ptr(), B, T, C, int(dilation), kernels.stream(),
        ),
        "depthwise_conv7_backward_taps",
    )
    kernels.count_launch("depthwise_conv7_backward_taps")
    return dy, part.view(B, tiles, C).sum(1)


def depthwise_conv7_norm_backward(go, x, step, cond, mask, k, b, ln_scale, ln_bias,
                                  dilation: int):
    """K10's backward: kernel A then kernel B -> (dx, dstep, dcond, dk, db,
    dln_scale, dln_bias), dx and dcond one tensor (see
    ``depthwise_conv7_norm_backward_reference``)."""
    dh, dk, db, dw, dlb = depthwise_conv7_norm_backward_rows(
        go.contiguous(), x, step, cond, mask, k, b, ln_scale, dilation)
    dy, dstep = depthwise_conv7_backward_taps(dh, mask, k, dilation)
    return dy, dstep, dy, dk, db, dw, dlb


class DepthwiseConv7NormFunction(torch.autograd.Function):
    """K10 with a gradient: (x, step, cond, mask, k, b, ln_scale, ln_bias,
    dilation) -> out. The forward is the serving kernel (grad is off
    inside it) and saves its inputs, no new activation; the backward is
    ``depthwise_conv7_norm_backward``. The one tensor returned for x and
    cond is never written in place: autograd accumulates into a copy
    where an input has other uses."""

    @staticmethod
    def forward(ctx, x, step, cond, mask, k, b, ln_scale, ln_bias, dilation):
        ctx.save_for_backward(x, step, cond, mask, k, b, ln_scale, ln_bias)
        ctx.dilation = dilation
        return depthwise_conv7_norm(x, step, cond, mask, k, b, ln_scale, ln_bias, dilation)

    @staticmethod
    def backward(ctx, go):
        x, step, cond, mask, k, b, ln_scale, ln_bias = ctx.saved_tensors
        dx, dstep, dcond, dk, db, dw, dlb = depthwise_conv7_norm_backward(
            go, x, step, cond, mask, k, b, ln_scale, ln_bias, ctx.dilation)
        return dx, dstep, dcond, None, dk, db, dw, dlb, None


class ConvNeXtBlock(nn.Module):
    """Depthwise conv7 + LayerNorm (K10), pointwise MLP, layer scale, with
    the block's step and condition projections (reference
    ``fish_diffusion/modules/convnext.py:12-92``)."""

    def __init__(self, dim: int, intermediate_dim: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.dwconv = nn.Conv1d(dim, dim, TAPS, padding=3 * dilation, dilation=dilation,
                                groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))
        self.diffusion_step_projection = nn.Conv1d(dim, dim, 1)
        self.condition_projection = nn.Conv1d(dim, dim, 1)

    def forward(self, x, step, cond, k, x_masks):
        """x [B, T, C]; step the diffusion embedding [B, C]; cond this
        block's condition projection [B, T, C]; k the depthwise kernel [7, C]."""
        s = _pointwise(self.diffusion_step_projection, step)
        h = depthwise_conv7_norm(x, s, cond, x_masks, k, self.dwconv.bias,
                                 self.norm.weight, self.norm.bias, self.dilation)
        h = self.pwconv2(F.gelu(self.pwconv1(h)))
        x = x + self.gamma * h
        if x_masks is not None:
            x = x.masked_fill(x_masks[:, :, None], 0.0)
        return x


def _pointwise(conv: nn.Conv1d, x):
    """A kernel-1 ``Conv1d`` over channels-last input."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


@DENOISERS.register_module(name="ConvNextDenoiser")
class ConvNext(nn.Module):
    """x [B, T, mel_channels], diffusion_step [B], conditioner
    [B, T, condition_dim] -> noise estimate [B, T, mel_channels] (float32).
    Block i has dilation 2 ** (i % dilation_cycle)."""

    def __init__(
        self,
        mel_channels: int = 128,
        dim: int = 512,
        mlp_factor: int = 4,
        condition_dim: int = 256,
        num_layers: int = 20,
        dilation_cycle: int = 4,
        cross_attention: bool = False,
    ):
        super().__init__()
        if cross_attention:
            raise NotImplementedError(
                "ConvNext with cross_attention is not ported yet (ROADMAP Queue 1, "
                "Other denoisers: ConvNeXt cross-attention)")
        self.dim = dim
        self.input_projection = nn.Conv1d(mel_channels, dim, 1)
        self.diffusion_embedding = nn.Sequential(
            nn.Identity(),  # the sinusoidal embedding, computed in forward
            nn.Linear(dim, dim * mlp_factor),
            nn.GELU(),
            nn.Linear(dim * mlp_factor, dim),
        )
        self.conditioner_projection = nn.Sequential(
            nn.Conv1d(condition_dim, dim * mlp_factor, 1),
            nn.GELU(),
            nn.Conv1d(dim * mlp_factor, dim, 1),
        )
        self.residual_layers = nn.ModuleList(
            ConvNeXtBlock(dim, dim * mlp_factor, 2 ** (i % dilation_cycle))
            for i in range(num_layers)
        )
        self.output_projection = nn.Sequential(
            nn.Conv1d(dim, dim, 1),
            nn.GELU(),
            nn.Conv1d(dim, mel_channels, 1),
        )

    def _condition(self, conditioner, cond_masks):
        """The conditioner projection [B, T, C], 0 at padding."""
        proj = self.conditioner_projection
        c = _pointwise(proj[2], F.gelu(_pointwise(proj[0], conditioner.float())))
        return c if cond_masks is None else c.masked_fill(cond_masks[:, :, None], 0.0)

    @staticmethod
    def _kernel(layer):
        """A block's depthwise kernel in K10's layout [7, C]."""
        return layer.dwconv.weight[:, 0, :].t()

    def prepare(self, conditioner: torch.Tensor,
                cond_masks: Optional[torch.Tensor] = None) -> dict:
        """Per-sampling-call constants, one entry a block: ``cond``, the
        block's condition projection ``[B, T, C]`` of the masked conditioner
        projection, and ``k``, its depthwise kernel ``[7, C]``."""
        c = self._condition(conditioner, cond_masks)
        layers = self.residual_layers
        return {
            "cond": [_pointwise(layer.condition_projection, c) for layer in layers],
            "k": [self._kernel(layer).contiguous() for layer in layers],
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
        plan = plan or self.prepare(conditioner, cond_masks)
        x = F.gelu(_pointwise(self.input_projection, x.float()))
        step = self.diffusion_embedding(diffusion_embedding(diffusion_step, self.dim))
        if x_masks is not None:
            x = x.masked_fill(x_masks[:, :, None], 0.0)
        for layer, cond, k in zip(self.residual_layers, plan["cond"], plan["k"]):
            x = layer(x, step, cond, k, x_masks)
        proj = self.output_projection
        x = _pointwise(proj[2], F.gelu(_pointwise(proj[0], x)))
        if x_masks is not None:
            x = x.masked_fill(x_masks[:, :, None], 0.0)
        return x.float()
