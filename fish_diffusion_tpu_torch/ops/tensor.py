"""Host-side tensor glue (``fish_diffusion_tpu/ops/tensor.py:repeat_expand_np``,
a copy)."""

from __future__ import annotations

import numpy as np


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
        # f32 intermediates to match the JAX package's rounding exactly
        scale = np.float32(src_len / target_len)
        pos = np.clip(
            (np.arange(target_len, dtype=np.float32) + np.float32(0.5)) * scale
            - np.float32(0.5),
            np.float32(0.0),
            np.float32(src_len - 1),
        )
        lo = np.floor(pos).astype(np.int64)
        hi = np.clip(lo + 1, 0, src_len - 1)
        w = (pos - lo).astype(content.dtype)
        result = content[..., lo] * (1 - w) + content[..., hi] * w
    else:
        raise NotImplementedError(mode)

    if ndim == 1:
        return result[0, 0]
    if ndim == 2:
        return result[0]
    return result
