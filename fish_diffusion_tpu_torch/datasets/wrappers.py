"""Dataset wrappers (``fish_diffusion_tpu/datasets/wrappers.py``)."""

from __future__ import annotations

import numpy as np

from ..registry import DATASETS


@DATASETS.register_module()
class ConcatDataset:
    """Several datasets one after another (the multi-speaker configs give
    one per speaker); batches collate with the first one's ``collate_fn``
    unless one is given."""

    def __init__(self, datasets, collate_fn=None):
        self.datasets = [DATASETS.build(d) if isinstance(d, dict) else d for d in datasets]
        self._collate = collate_fn or self.datasets[0].collate_fn
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        ds_idx = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[ds_idx][idx - int(self._offsets[ds_idx])]

    @property
    def collate_fn(self):
        return self._collate
