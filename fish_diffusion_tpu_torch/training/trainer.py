"""Training logs (``fish_diffusion_tpu/training/trainer.py:MetricsLogger``)."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


class MetricsLogger:
    """One JSON object per line in ``<log_dir>/metrics.jsonl``
    (``{"step", "time", **scalars}``, the JAX package's keys), and audio
    as wav files beside it."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def log_scalars(self, step: int, scalars: dict):
        rec = {"step": step, "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_audio(self, step: int, tag: str, wav: np.ndarray, sample_rate: int):
        from ..utils.audio import save_wav

        save_wav(self.log_dir / f"{tag.replace('/', '_')}_{step}.wav", wav,
                 sample_rate)

    def close(self):
        self._jsonl.close()
