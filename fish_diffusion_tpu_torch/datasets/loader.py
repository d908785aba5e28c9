"""Data loaders (``fish_diffusion_tpu/datasets/loader.py``) on one device,
over ``torch.utils.data.DataLoader``: fixed-size batches (``drop_last``, as
the JAX loader's default), collated by the dataset's ``collate_fn``, with
worker processes started by ``spawn`` when the config asks for workers."""

from __future__ import annotations

import multiprocessing

from torch.utils.data import DataLoader

from ..registry import DATASETS


def build_loader(dataset_cfg: dict, loader_cfg: dict) -> DataLoader:
    from . import naive, wrappers  # noqa: F401  (registers the dataset types)

    dataset = DATASETS.build(dict(dataset_cfg))
    cfg = dict(loader_cfg)
    workers = int(cfg.pop("num_workers", 0))
    cfg.pop("persistent_workers", None)  # the JAX loader's no-op
    return DataLoader(
        dataset, collate_fn=dataset.collate_fn, drop_last=cfg.pop("drop_last", True),
        num_workers=workers,
        multiprocessing_context=multiprocessing.get_context("spawn") if workers else None,
        **cfg,
    )


def build_loader_from_config(cfg):
    """(train_loader, valid_loader) from a config's ``dataset`` and
    ``dataloader`` sections."""
    return (build_loader(cfg.dataset.train, cfg.dataloader.train),
            build_loader(cfg.dataset.valid, cfg.dataloader.valid))
