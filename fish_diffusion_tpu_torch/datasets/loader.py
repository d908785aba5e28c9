"""Data loaders (``fish_diffusion_tpu/datasets/loader.py``) on one device,
over ``torch.utils.data.DataLoader``: fixed-size batches (``drop_last``, as
the JAX loader's default), collated by the dataset's ``collate_fn``, with
worker processes started by ``spawn`` when the config asks for workers.

The order of the items is the JAX loader's (``DataLoader._batch_indices``):
``SeededBatchSampler`` draws each epoch's permutation from one
``np.random.default_rng(seed)`` kept across epochs, so two runs of one
config train on the same batches, and on the same ones as the JAX package.
"""

from __future__ import annotations

import multiprocessing

import numpy as np
from torch.utils.data import DataLoader

from ..registry import DATASETS


class SeededBatchSampler:
    """Batches of item indices in the JAX loader's order: each epoch
    ``rng.shuffle(np.arange(n))`` (when ``shuffle``) from one
    ``np.random.default_rng(seed)``, then consecutive runs of
    ``batch_size``, the last short one kept unless ``drop_last``."""

    def __init__(self, n: int, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 42):
        self.n, self.batch_size = n, batch_size
        self.shuffle, self.drop_last = shuffle, drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __iter__(self):
        indices = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(indices)
        bs = self.batch_size
        return iter([indices[i:i + bs].tolist() for i in range(0, len(self) * bs, bs)])


def build_loader(dataset_cfg: dict, loader_cfg: dict) -> DataLoader:
    """A loader config's keys: ``batch_size``, ``shuffle``, ``drop_last``
    and ``seed`` (42) make the order (``SeededBatchSampler``);
    ``num_workers``; ``prefetch`` and ``persistent_workers`` are the JAX
    loader's and are dropped; any other key goes to ``DataLoader``."""
    from . import naive, wrappers  # noqa: F401  (registers the dataset types)

    dataset = DATASETS.build(dict(dataset_cfg))
    cfg = dict(loader_cfg)
    workers = int(cfg.pop("num_workers", 0))
    cfg.pop("persistent_workers", None)
    cfg.pop("prefetch", None)
    sampler = SeededBatchSampler(
        len(dataset), batch_size=cfg.pop("batch_size", 1), shuffle=cfg.pop("shuffle", False),
        drop_last=cfg.pop("drop_last", True), seed=cfg.pop("seed", 42))
    return DataLoader(
        dataset, batch_sampler=sampler, collate_fn=dataset.collate_fn, num_workers=workers,
        multiprocessing_context=multiprocessing.get_context("spawn") if workers else None,
        **cfg,
    )


def build_loader_from_config(cfg):
    """(train_loader, valid_loader) from a config's ``dataset`` and
    ``dataloader`` sections."""
    return (build_loader(cfg.dataset.train, cfg.dataloader.train),
            build_loader(cfg.dataset.valid, cfg.dataloader.valid))
