"""Length masks. As in ``fish_diffusion_tpu/ops/masking.py``, ``True`` marks
PADDING positions."""

from __future__ import annotations

import torch


def get_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask, True where index >= length."""
    ids = torch.arange(max_len, device=lengths.device)[None, :]
    return ids >= lengths[:, None]
