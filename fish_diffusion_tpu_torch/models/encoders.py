"""Condition encoders (``fish_diffusion_tpu/models/encoders.py``)."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from ..ops import pitch as pitch_ops
from ..registry import ENCODERS

_PREPROCESSING_FNS = {"pitch_to_scale": pitch_ops.pitch_to_scale}


def resolve_preprocessing(
    preprocessing: Union[str, Callable, None]
) -> Optional[Callable]:
    if preprocessing is None or callable(preprocessing):
        return preprocessing
    if preprocessing in _PREPROCESSING_FNS:
        return _PREPROCESSING_FNS[preprocessing]
    raise KeyError(
        f"Unknown preprocessing {preprocessing!r}; "
        f"available: {sorted(_PREPROCESSING_FNS)}"
    )


@ENCODERS.register_module()
class NaiveProjectionEncoder(nn.Module):
    """Embedding, linear or bottleneck projection (keys ``embedding``,
    ``projection``, ``projection.0``/``projection.1``)."""

    def __init__(
        self,
        input_size: int,
        output_size: int,
        use_embedding: bool = False,
        use_neck: bool = False,
        neck_size: int = 8,
        preprocessing: Union[str, Callable, None] = None,
    ):
        super().__init__()
        self.use_embedding = use_embedding
        self.preprocessing = resolve_preprocessing(preprocessing)
        if use_embedding:
            self.embedding = nn.Embedding(input_size, output_size)
        elif use_neck:
            self.projection = nn.Sequential(
                nn.Linear(input_size, neck_size), nn.Linear(neck_size, output_size)
            )
        else:
            self.projection = nn.Linear(input_size, output_size)

    def forward(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        if self.preprocessing is not None:
            x = self.preprocessing(x)
        if self.use_embedding:
            return self.embedding(x.long())
        return self.projection(x.float())
