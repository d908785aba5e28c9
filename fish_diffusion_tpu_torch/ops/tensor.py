"""Length adaption (``fish_diffusion_tpu/ops/tensor.py``): the host-side
``repeat_expand_np`` (a copy) and ``repeat_expand`` on tensors, whose
gradient is a gather in a fixed order."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable


def repeat_expand_np(content, target_len: int, mode: str = "nearest"):
    """Stretch the last axis of a [C, T] (or [T], [B, C, T]) array to
    ``target_len`` by nearest or linear interpolation."""
    content = np.asarray(content)
    ndim = content.ndim
    if ndim == 1:
        content = content[None, None]
    elif ndim == 2:
        content = content[None]
    if content.ndim != 3:
        raise ValueError(f"expected 1-3 axes, got {content.ndim}")

    src_len = content.shape[-1]
    if mode == "nearest":
        idx = np.clip(
            (np.arange(target_len) * (src_len / target_len)).astype(np.int64),
            0,
            src_len - 1,
        )
        result = content[..., idx]
    elif mode == "linear":
        lo, hi, w = _linear_taps(src_len, target_len)
        w = w.astype(content.dtype)
        result = content[..., lo] * (1 - w) + content[..., hi] * w
    else:
        raise NotImplementedError(mode)

    if ndim == 1:
        return result[0, 0]
    if ndim == 2:
        return result[0]
    return result


def _linear_taps(src_len: int, target_len: int):
    """Linear mode's source rows and weights, with float32 intermediates to
    match the JAX package's rounding exactly: output j reads rows lo[j] and
    hi[j] with weights 1 - w[j] and w[j]."""
    scale = np.float32(src_len / target_len)
    pos = np.clip(
        (np.arange(target_len, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5),
        np.float32(0.0),
        np.float32(src_len - 1),
    )
    lo = np.floor(pos).astype(np.int64)
    hi = np.clip(lo + 1, 0, src_len - 1)
    w = (pos - lo).astype(np.float32)
    return lo, hi, w


def linear_gather_table(src_len: int, target_len: int):
    """The transpose of linear resampling as a gather: for each source row
    i, the outputs j that read it (as lo, then as hi, each in increasing j)
    and their weights, padded to one width M with weight 0 ->
    (index [src_len, M] int64, weight [src_len, M] float32), numpy."""
    lo, hi, w = _linear_taps(src_len, target_len)
    src = np.concatenate([lo, hi])
    out = np.concatenate([np.arange(target_len)] * 2)
    weight = np.concatenate([np.float32(1) - w, w])
    order = np.argsort(src, kind="stable")
    src, out, weight = src[order], out[order], weight[order]
    counts = np.bincount(src, minlength=src_len)
    slot = np.arange(src.size) - np.repeat(np.cumsum(counts) - counts, counts)
    index = np.zeros((src_len, max(int(counts.max()), 1)), np.int64)
    table = np.zeros(index.shape, np.float32)
    index[src, slot] = out
    table[src, slot] = weight
    return index, table


# (src_len, target_len, device) -> the gather table on that device
_TABLES: dict = {}


def _gather_table(src_len: int, target_len: int, device):
    key = (src_len, target_len, str(device))
    if key not in _TABLES:
        index, weight = linear_gather_table(src_len, target_len)
        _TABLES[key] = (torch.from_numpy(index).to(device),
                        torch.from_numpy(weight).to(device))
    return _TABLES[key]


class _LinearResample(torch.autograd.Function):
    """Linear resampling of the last axis of [N, C, T]. The forward is
    ``F.interpolate`` (half-pixel, align_corners False). Its backward is
    the transpose written as a gather in the source's order: each source
    row sums the gradients of the outputs that read it, over a fixed table
    (``linear_gather_table``), so a rerun gives the same bits on the card.
    ``F.interpolate``'s own CUDA backward adds with atomics, in an order
    that varies from run to run."""

    @staticmethod
    def forward(ctx, x, target_len: int):
        ctx.src_len = x.shape[-1]
        return F.interpolate(x, size=target_len, mode="linear", align_corners=False)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        index, weight = _gather_table(ctx.src_len, grad.shape[-1], grad.device)
        taps = grad.index_select(-1, index.flatten()).view(*grad.shape[:-1], *index.shape)
        return (taps * weight.to(grad.dtype)).sum(-1), None


def repeat_expand(content, target_len: int):
    """Stretch the last axis of a [C, T] (or [T], [B, C, T]) tensor to
    ``target_len`` by linear interpolation
    (``fish_diffusion_tpu/ops/tensor.py:repeat_expand`` in ``linear``
    mode): ``F.interpolate`` with half-pixel sampling, align_corners False,
    clamped at the edges; up and down alike, without antialiasing, as the
    JAX function. Its gradient is a fixed-order gather
    (``_LinearResample``)."""
    ndim = content.ndim
    if not 1 <= ndim <= 3:
        raise ValueError(f"expected 1-3 axes, got {ndim}")
    x = content.reshape((1,) * (3 - ndim) + tuple(content.shape))
    out = _LinearResample.apply(x, target_len)
    return out.reshape(tuple(content.shape[:-1]) + (target_len,))
