"""Training data (``fish_diffusion_tpu/datasets/naive.py``): one ``.npy``
file per clip holding a pickled dict (the preprocessing contract): the
vocoder's ``{path, audio, pitches, sampling_rate}``, the SVC model's
``{path, mel [M, T], contents [C, T], pitches [T], key_shift,
time_stretch}`` (of which the denoiser's dataset reads path, mel and
contents). Every item carries the dataset's ``speaker_id``. The
files are the repository's own preprocessing output, so
``np.load(allow_pickle=True)`` reads only what this program wrote."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..registry import DATASETS
from .utils import DEFAULT_BUCKET, list_files, transform_pipeline


class NaiveDataset:
    processing_pipeline: list = []
    collating_pipeline: list = []
    bucket = DEFAULT_BUCKET

    def __init__(self, path="dataset", speaker_id=0):
        self.paths = list_files(path, {".npy"})
        self.speaker_id = speaker_id
        if not self.paths:
            raise FileNotFoundError(f"No files found in {path}, check your path.")

    def __len__(self):
        return len(self.paths)

    def get_item(self, idx):
        x = np.load(self.paths[idx], allow_pickle=True).item()
        x["speaker"] = self.speaker_id
        return transform_pipeline(self.processing_pipeline, x)

    def __getitem__(self, idx):
        try:
            return self.get_item(idx)
        except (OSError, ValueError, KeyError) as err:
            print(f"Error when loading {self.paths[idx]} ({err}), skipping...")
            return None

    @classmethod
    def collate_fn(cls, data):
        data = [x for x in data if x is not None]
        return transform_pipeline(cls.collating_pipeline, data, bucket=cls.bucket)


@DATASETS.register_module()
class NaiveSVCDataset(NaiveDataset):
    """SVC training items: mel and contents time-major [T, C], padded to a
    bucket of 128 frames in a batch; pitches [B, T, 1]; key_shift and
    time_stretch [B, 1]; speaker [B]."""

    processing_pipeline = [
        dict(type="PickKeys", keys=["path", "time_stretch", "mel", "contents", "pitches",
                                    "key_shift", "speaker"]),
        dict(type="Transpose", keys=[("mel", 1, 0), ("contents", 1, 0)]),
    ]
    collating_pipeline = [
        dict(type="ListToDict"),
        dict(type="PadStack", keys=[("mel", -2), ("contents", -2), ("pitches", -1)]),
        dict(type="ToTensor", keys=[("time_stretch", "float32"), ("key_shift", "float32"),
                                    ("speaker", "int64")]),
        dict(type="UnSqueeze", keys=[("pitches", -1), ("time_stretch", -1),
                                     ("key_shift", -1)]),
    ]


@DATASETS.register_module()
class NaiveDenoiserDataset(NaiveDataset):
    """Denoiser training pairs: mel and contents time-major [T, C], padded to
    a bucket of 128 frames in a batch. No pitches and no speaker: a model
    with a pitch encoder (DiffSVC) cannot train on it."""

    processing_pipeline = [
        dict(type="PickKeys", keys=["path", "mel", "contents"]),
        dict(type="Transpose", keys=[("mel", 1, 0), ("contents", 1, 0)]),
    ]
    collating_pipeline = [
        dict(type="ListToDict"),
        dict(type="PadStack", keys=[("mel", -2), ("contents", -2)]),
    ]


@DATASETS.register_module()
class NaiveVOCODERDataset(NaiveDataset):
    """Raw audio + f0 with pitch shift (linear-interpolation resampling),
    loudness shift and a random fixed-size crop."""

    processing_pipeline = [
        dict(type="PickKeys", keys=["path", "audio", "pitches", "sampling_rate"]),
    ]
    collating_pipeline = [
        dict(type="ListToDict"),
        dict(type="PadStack", keys=[("audio", -1), ("pitches", -1)]),
    ]

    def __init__(self, path="dataset", segment_size: Optional[int] = 16384,
                 hop_length: int = 512, sampling_rate: int = 44100,
                 pitch_shift: Optional[list] = None,
                 loudness_shift: Optional[list] = None):
        super().__init__(path)
        self.segment_length = segment_size
        self.hop_length = hop_length
        self.sampling_rate = sampling_rate
        self.pitch_shift = pitch_shift
        self.loudness_shift = loudness_shift

    def __getitem__(self, idx):
        x = super().__getitem__(idx)
        if x is None:
            return None
        if x["sampling_rate"] != self.sampling_rate:
            raise ValueError(f"{self.paths[idx]}: sampling rate {x['sampling_rate']}, "
                             f"expected {self.sampling_rate}")
        y = np.asarray(x["audio"], np.float32)
        pitches = np.asarray(x["pitches"], np.float32)

        if self.pitch_shift is not None:
            lo, hi = self.pitch_shift
            shift = np.random.random() * (hi - lo) + lo
            orig_sr = round(self.sampling_rate * 2 ** (shift / 12))
            orig_sr = orig_sr - orig_sr % 100
            new_len = int(round(len(y) * self.sampling_rate / orig_sr))
            y = np.interp(np.linspace(0, len(y) - 1, new_len), np.arange(len(y)),
                          y).astype(np.float32)
            pitches = pitches * 2 ** (shift / 12)

        pitches = np.interp(np.linspace(0, 1, y.shape[-1]),
                            np.linspace(0, 1, len(pitches)), pitches).astype(np.float32)

        if self.segment_length is not None:
            if y.shape[-1] > self.segment_length:
                start = np.random.randint(0, y.shape[-1] - self.segment_length + 1)
                y = y[start : start + self.segment_length]
                pitches = pitches[start : start + self.segment_length]
            elif y.shape[-1] < self.segment_length:
                pad = self.segment_length - y.shape[-1]
                y = np.pad(y, (0, pad))
                pitches = np.pad(pitches, (0, pad))

        if self.loudness_shift is not None:
            lo, hi = self.loudness_shift
            new_amplitude = np.random.random() * (hi - lo) + lo
            y = y / (np.max(np.abs(y)) + 1e-8) * new_amplitude

        return {"audio": y[None], "pitches": pitches[None]}
