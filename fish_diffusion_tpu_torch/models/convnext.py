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

The per-block condition projections ``[L, B, T, C]`` and the depthwise
kernels in the layout K10 reads ``[L, 7, C]`` are constant across the
reverse-diffusion steps, so ``prepare`` computes them once per sampling
call. Module and parameter names are fish-diffusion's torch layout, which
``tools/diffusion/convert_torch_checkpoint.py:convert_convnext`` reads.

Not ported: the interleaved cross-attention blocks (``cross_attention``;
ROADMAP Queue 1, "Other denoisers"; no config sets it), and K10's backward:
on the card the module serves only, and raises under grad.
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
# memory, with THREADS + 2 * ROWS floats for the row statistics
_ROWS, _THREADS, _SMEM_LIMIT = 16, 256, 232448
MAX_CHANNELS = (_SMEM_LIMIT // 4 - _THREADS - 2 * _ROWS) // _ROWS


def depthwise_conv7_norm_reference(x, step, cond, mask, k, b, ln_scale, ln_bias,
                                   dilation: int):
    """Plain version of K10. x, cond [B, T, C]; step [B, C]; mask [B, T]
    (True at padding) or None; k [7, C]; b, ln_scale, ln_bias [C] ->
    LayerNorm over C (eps 1e-6) of h [B, T, C] with
    y[t] = 0 if mask[t] else x[t] + step + cond[t] (0 outside [0, T)) and
    h[t, c] = b[c] + sum_j k[j, c] y[t + (j - 3) d, c]."""
    y = x + step[:, None, :] + cond
    if mask is not None:
        y = y.masked_fill(mask[:, :, None], 0.0)
    h = b + sum(k[j] * shift_time(y, -(j - 3) * dilation) for j in range(TAPS))
    return F.layer_norm(h, (h.shape[-1],), ln_scale, ln_bias, LN_EPS)


def depthwise_conv7_norm(x, step, cond, mask, k, b, ln_scale, ln_bias, dilation: int):
    """K10: ``csrc/convnext_block.cu`` ``depthwise_conv7_norm`` (see
    ``depthwise_conv7_norm_reference``, which CPU tensors take). float32;
    any T and dilation, C up to ``MAX_CHANNELS``. It has no backward yet:
    with grad enabled and an input that requires it, it raises."""
    if not x.is_cuda:
        return depthwise_conv7_norm_reference(x, step, cond, mask, k, b, ln_scale,
                                              ln_bias, dilation)
    tensors = (x, step, cond, k, b, ln_scale, ln_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "depthwise_conv7_norm (K10) has no backward yet: ConvNeXt training "
            "on the card comes with it (ROADMAP Queue 2, K10's backward)")
    kernels.require_cuda("depthwise_conv7_norm", *tensors)
    if x.dtype != torch.float32:
        raise TypeError(f"depthwise_conv7_norm: takes float32, got {x.dtype}")
    B, T, C = x.shape
    for name, t, shape in (("step", step, (B, C)), ("cond", cond, (B, T, C)),
                           ("k", k, (TAPS, C)), ("b", b, (C,)),
                           ("ln_scale", ln_scale, (C,)), ("ln_bias", ln_bias, (C,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"depthwise_conv7_norm: {name} {tuple(t.shape)} != {shape}")
    if C > MAX_CHANNELS:
        raise ValueError(f"depthwise_conv7_norm: {C} channels > {MAX_CHANNELS}")
    if dilation < 1:
        raise ValueError(f"depthwise_conv7_norm: dilation {dilation} < 1")
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (B, T)
                             or mask.device != x.device or not mask.is_contiguous()):
        raise ValueError("depthwise_conv7_norm: mask must be a contiguous bool [B, T] "
                         "tensor on x's device")
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

    def prepare(self, conditioner: torch.Tensor,
                cond_masks: Optional[torch.Tensor] = None) -> dict:
        """Per-sampling-call constants: each block's condition projection
        ``cond [L, B, T, C]`` of the masked conditioner projection, and the
        depthwise kernels ``k [L, 7, C]``."""
        proj = self.conditioner_projection
        c = _pointwise(proj[2], F.gelu(_pointwise(proj[0], conditioner.float())))
        if cond_masks is not None:
            c = c.masked_fill(cond_masks[:, :, None], 0.0)
        layers = self.residual_layers
        return {
            "cond": torch.stack([_pointwise(layer.condition_projection, c)
                                 for layer in layers]),
            "k": torch.stack([layer.dwconv.weight[:, 0, :].t() for layer in layers])
                      .contiguous(),
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
        if plan is None:
            plan = self.prepare(conditioner, cond_masks)
        x = F.gelu(_pointwise(self.input_projection, x.float()))
        step = self.diffusion_embedding(diffusion_embedding(diffusion_step, self.dim))
        if x_masks is not None:
            x = x.masked_fill(x_masks[:, :, None], 0.0)
        for i, layer in enumerate(self.residual_layers):
            x = layer(x, step, plan["cond"][i], plan["k"][i], x_masks)
        proj = self.output_projection
        x = _pointwise(proj[2], F.gelu(_pointwise(proj[0], x)))
        if x_masks is not None:
            x = x.masked_fill(x_masks[:, :, None], 0.0)
        return x.float()
