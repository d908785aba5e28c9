"""The port's training order against the JAX loader's on the CPU.

The JAX ``DataLoader`` draws each epoch's permutation from one
``np.random.default_rng(seed)`` kept across epochs
(``fish_diffusion_tpu/datasets/loader.py``, ``_batch_indices``); the port's
``build_loader`` batches with ``SeededBatchSampler``, which must give the
same indices, epoch after epoch, for every ``shuffle`` / ``drop_last``
setting, and take the JAX loader's config keys (``seed``, ``prefetch``).
"""

from pathlib import Path

import numpy as np
import pytest

from fish_diffusion_tpu.datasets.loader import DataLoader as JaxLoader
from fish_diffusion_tpu.datasets.naive import NaiveSVCDataset as JaxSVCDataset
from fish_diffusion_tpu_torch.datasets.loader import SeededBatchSampler, build_loader


def write_items(root: Path, n: int):
    """``n`` SVC ``.npy`` dicts of 6-17 frames, item i's path ``i.wav``."""
    rng = np.random.default_rng(n)
    root.mkdir(parents=True)
    for i in range(n):
        T = int(rng.integers(6, 18))
        np.save(root / f"{i}.npy", {
            "path": f"{i}.wav", "time_stretch": 1.0, "key_shift": 0.0,
            "mel": rng.uniform(-5, 0, (128, T)).astype(np.float32),
            "contents": rng.standard_normal((256, T)).astype(np.float32),
            "pitches": rng.uniform(80, 600, T).astype(np.float32)})


@pytest.mark.parametrize("n,batch_size", [(23, 4), (24, 4), (5, 8)])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_indices_follow_the_jax_loader(n, batch_size, shuffle, drop_last):
    """Three epochs of ``SeededBatchSampler`` equal the JAX loader's
    ``_batch_indices`` at the same seed, and so does its length."""
    jax_loader = JaxLoader(list(range(n)), batch_size=batch_size, shuffle=shuffle,
                           drop_last=drop_last, seed=7)
    sampler = SeededBatchSampler(n, batch_size, shuffle, drop_last, seed=7)
    assert len(sampler) == len(jax_loader)
    for _ in range(3):
        want = [b.tolist() for b in jax_loader._batch_indices()]
        assert list(sampler) == want


def paths(loader):
    return [[int(p.split(".")[0]) for p in batch["path"]] for batch in loader]


def test_build_loader_takes_the_jax_keys_and_its_order(tmp_path):
    """A loader config with the JAX loader's ``seed`` and ``prefetch`` keys
    builds; two epochs of its batches hold the items of the JAX loader's
    batches over the same files and seed, in order; a second loader from the
    same config repeats the order, and another seed changes it."""
    write_items(tmp_path / "train", 11)
    dataset = dict(type="NaiveSVCDataset", path=str(tmp_path / "train"))
    cfg = dict(batch_size=3, shuffle=True, num_workers=0, persistent_workers=True,
               prefetch=4, seed=5)
    loader = build_loader(dataset, cfg)
    assert len(loader) == 3
    got = paths(loader) + paths(loader)

    jax_set = JaxSVCDataset(str(tmp_path / "train"))
    names = [Path(str(jax_set[i]["path"])).stem for i in range(len(jax_set))]
    jax_loader = JaxLoader(jax_set, batch_size=3, shuffle=True, seed=5)
    want = [[int(names[i]) for i in batch]
            for _ in range(2) for batch in jax_loader._batch_indices()]
    assert got == want
    again = build_loader(dataset, cfg)
    assert paths(again) + paths(again) == got
    other = build_loader(dataset, {**cfg, "seed": 6})
    assert paths(other) != got[:3]


def test_build_loader_defaults_to_the_jax_seed_and_order(tmp_path):
    """Without ``seed`` the order is the JAX loader's default (42); without
    ``shuffle`` it is the files' order; ``drop_last`` defaults to True."""
    write_items(tmp_path / "train", 7)
    dataset = dict(type="NaiveSVCDataset", path=str(tmp_path / "train"))
    jax_set = JaxSVCDataset(str(tmp_path / "train"))
    names = [int(Path(str(jax_set[i]["path"])).stem) for i in range(len(jax_set))]
    for shuffle in (True, False):
        loader = build_loader(dataset, dict(batch_size=2, shuffle=shuffle))
        jax_loader = JaxLoader(jax_set, batch_size=2, shuffle=shuffle)
        assert len(loader) == len(jax_loader) == 3
        assert paths(loader) == [[names[i] for i in b] for b in jax_loader._batch_indices()]
