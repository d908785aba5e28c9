"""Monotonic (maximum-path) alignment, GlowTTS/VITS style
(``fish_diffusion_tpu/ops/monotonic_align.py``).

The forward DP ``v[y, x] = value[y, x] + max(v[y-1, x-1], v[y-1, x])``
(row 0 pinned to x = 0 with -1e9, -1e9 shifted in at x = 0), then the
backtrack from ``(t_y - 1, t_x - 1)`` that moves one text position left
iff ``index != 0 and (index == y or v[y-1, index] < v[y-1, index-1])``,
gives a 0/1 path ``[B, T_y, T_x]``, 0 at rows >= t_y and columns >= t_x.

``maximum_path`` is K7, the hand-written CUDA kernel of
``csrc/monotonic_align.cu`` (one block per item, one warp's registers
holding the row, the rows of values staged by bulk copies, a decision bit
per cell in shared memory, the backtrack in one thread; the path's zeros
written by the block's other warps during the DP), for a CUDA tensor; a
CPU tensor takes ``maximum_path_reference``, the JAX op's scan formulation
in torch (one row update per frame, then the backtrack over the batch).
Both follow the JAX op's float32 order and its strict ``<``, so their
paths are bit-equal to it. ``maximum_path_numpy`` is the host
golden reference, a copy of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

_NEG = -1e9


def _lengths(t, T: int, device) -> torch.Tensor:
    """Lengths as int32 on ``device``, clamped to [0, T]."""
    return torch.as_tensor(t, device=device).to(torch.int32).clamp(0, T).contiguous()


def maximum_path_reference(neg_cent: torch.Tensor, t_ys, t_xs) -> torch.Tensor:
    """Plain version of K7: values [B, T_y, T_x] (higher is better), valid
    lengths [B] -> path [B, T_y, T_x] int32."""
    B, T_y, T_x = neg_cent.shape
    t_ys = _lengths(t_ys, T_y, neg_cent.device).long()
    t_xs = _lengths(t_xs, T_x, neg_cent.device).long()
    x_idx = torch.arange(T_x, device=neg_cent.device)
    neg = torch.full((B, 1), _NEG, dtype=neg_cent.dtype, device=neg_cent.device)
    v = neg_cent[:, 0] + torch.where(x_idx == 0, 0.0, _NEG).to(neg_cent.dtype)
    rows = [v]
    for y in range(1, T_y):
        v = neg_cent[:, y] + torch.maximum(torch.cat([neg, v[:, :-1]], dim=1), v)
        rows.append(v)

    batch = torch.arange(B, device=neg_cent.device)
    index = t_xs - 1
    path = torch.zeros((B, T_y, T_x), dtype=torch.int32, device=neg_cent.device)
    for y in range(T_y - 1, -1, -1):
        active = y < t_ys
        path[:, y] = ((x_idx[None, :] == index[:, None]) & active[:, None]).int()
        if y > 0:
            prev = rows[y - 1]
            left = prev[batch, (index - 1).clamp(min=0)]
            same = prev[batch, index.clamp(min=0)]
            move = (index != 0) & ((index == y) | (same < left))
            index = torch.where(active, index - move.long(), index)
    return path * (x_idx[None, None, :] < t_xs[:, None, None])


def maximum_path(neg_cent: torch.Tensor, t_ys, t_xs) -> torch.Tensor:
    """K7: values [B, T_y, T_x] float32, valid lengths t_ys, t_xs [B] (in
    [1, T]; clamped to [0, T]) -> one-hot path [B, T_y, T_x] int32, equal to
    the JAX ``maximum_path`` and to ``maximum_path_numpy`` on the valid
    region. CPU tensors take ``maximum_path_reference``."""
    if not neg_cent.is_cuda:
        return maximum_path_reference(neg_cent, t_ys, t_xs)
    path = _maximum_path(neg_cent, t_ys, t_xs)
    kernels.count_launch("maximum_path")
    return path


def _maximum_path(neg_cent: torch.Tensor, t_ys, t_xs,
                  entry: str = "maximum_path") -> torch.Tensor:
    """K7's kernel on a CUDA tensor, uncounted. ``entry="maximum_path_chain"``
    launches the same kernel with each row's exchange, maximum and add on a
    value held in a register (the chain floor of a measurement; the path is
    not written)."""
    kernels.require_cuda("maximum_path", neg_cent)
    if neg_cent.dtype != torch.float32 or neg_cent.ndim != 3:
        raise TypeError("maximum_path: takes float32 values [B, T_y, T_x]")
    B, T_y, T_x = neg_cent.shape
    t_ys = _lengths(t_ys, T_y, neg_cent.device)
    t_xs = _lengths(t_xs, T_x, neg_cent.device)
    if t_ys.shape != (B,) or t_xs.shape != (B,):
        raise ValueError(f"maximum_path: lengths {tuple(t_ys.shape)}, "
                         f"{tuple(t_xs.shape)} for a batch of {B}")
    path = torch.empty((B, T_y, T_x), dtype=torch.int32, device=neg_cent.device)
    if path.numel() == 0:
        return path
    lib = kernels.load_library("monotonic_align")
    per_item = lib.maximum_path_plan(T_y, T_x, 3)
    if per_item < 0:
        raise ValueError(
            f"maximum_path: [{T_y}, {T_x}] exceeds the kernel: one warp keeps a row "
            "in registers (at most 2016 text positions) and shared memory holds "
            "each row's index (2 bytes a mel frame, about 75,000 frames or more)")
    scratch = (torch.empty(B * per_item, dtype=torch.uint8, device=neg_cent.device)
               if per_item else None)
    kernels.check(
        getattr(lib, entry)(neg_cent.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(),
                            None if scratch is None else scratch.data_ptr(), path.data_ptr(),
                            B, T_y, T_x, kernels.stream()),
        "maximum_path",
    )
    return path


def maximum_path_from_mask(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The reference's contract: mask [B, T_y, T_x] -> path in
    ``neg_cent``'s dtype (the DP runs in float32)."""
    t_ys = mask[:, :, 0].sum(dim=1).to(torch.int32)
    t_xs = mask[:, 0, :].sum(dim=1).to(torch.int32)
    return maximum_path(neg_cent.float().contiguous(), t_ys, t_xs).to(neg_cent.dtype)


def maximum_path_numpy(values: np.ndarray, t_ys: np.ndarray,
                       t_xs: np.ndarray) -> np.ndarray:
    """Plain-numpy golden reference (the same DP over the band, host-side)."""
    values = values.copy().astype(np.float32)
    B, T_y, T_x = values.shape
    paths = np.zeros_like(values, dtype=np.int32)

    for b in range(B):
        value = values[b]
        t_y, t_x = int(t_ys[b]), int(t_xs[b])

        for y in range(t_y):
            for x in range(max(0, t_x + y - t_y), min(t_x, y + 1)):
                v_cur = _NEG if x == y else value[y - 1, x]
                if x == 0:
                    v_prev = 0.0 if y == 0 else _NEG
                else:
                    v_prev = value[y - 1, x - 1]
                value[y, x] += max(v_prev, v_cur)

        index = t_x - 1
        for y in range(t_y - 1, -1, -1):
            paths[b, y, index] = 1
            if index != 0 and (
                index == y or value[y - 1, index] < value[y - 1, index - 1]
            ):
                index -= 1

    return paths
