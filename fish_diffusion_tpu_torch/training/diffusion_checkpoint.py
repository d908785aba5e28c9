"""Checkpoints of the diffusion training state (``fish_diffusion_tpu/training/checkpoint.py``).

One ``torch.save`` file per step, ``<directory>/<step>.pt``, holding the
step, the model's parameters, the optimizer (with its update count), the
EMA parameters (or None) and the metrics of the save:

- ``save_top_k`` keeps the k newest checkpoints (-1 keeps all, the configs'
  default), as orbax's ``max_to_keep`` does;
- ``every_n_train_steps`` skips a save whose step is not a multiple of it,
  unless ``force`` (the final save of a run);
- a step that a previous run left in the directory is overwritten, never
  kept; a step this manager already wrote is not written again.

``load_pretrained_params`` is the warm-start surgery of the JAX package's
``load_pretrained_params`` on state dicts: keys the target lacks are
dropped, shape mismatches (a speaker table of another size) skipped,
speaker embeddings optionally dropped, each skip printed.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

from .diffusion_state import TrainState


class CheckpointManager:
    def __init__(self, directory, save_top_k: int = -1,
                 save_interval_steps: Optional[int] = None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k
        self.interval = save_interval_steps
        self._written_steps: set = set()

    def _path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def all_steps(self):
        return sorted(int(p.stem) for p in self.directory.glob("*.pt") if p.stem.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, metrics: Optional[dict] = None, force: bool = False):
        step = int(state.step)
        if not force and self.interval and step % self.interval:
            return
        if step in self._written_steps:
            return
        payload = {
            "step": step,
            "params": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": None if state.ema is None else state.ema.state_dict(),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        path = self._path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)  # a previous run's file at this step is replaced
        self._written_steps.add(step)
        if self.save_top_k >= 0:
            for old in self.all_steps()[: -self.save_top_k or None]:
                self._path(old).unlink()

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load the checkpoint at ``step`` (default the latest) into
        ``state`` in place and return it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["params"])
        state.optimizer.load_state_dict(payload["optimizer"])
        if state.ema is not None:
            state.ema.load_state_dict(payload["ema"] if payload["ema"] is not None
                                      else payload["params"])
        state.step = int(payload["step"])
        return state


def load_pretrained_params(pretrained: dict, target: dict,
                           drop_speaker_embeddings: bool = False) -> dict:
    """``target`` (a state dict) with every entry of ``pretrained`` that it
    has, of the same shape, copied in; the rest printed as skipped."""
    merged = dict(target)
    skipped = []
    for key, value in pretrained.items():
        if key not in target:
            skipped.append((key, "unexpected"))
        elif tuple(value.shape) != tuple(target[key].shape):
            skipped.append((key, "shape mismatch"))
        elif drop_speaker_embeddings and "speaker_encoder" in key:
            skipped.append((key, "speaker embedding dropped"))
        else:
            merged[key] = value
    for key, reason in skipped:
        print(f"[pretrained] skipped {key}: {reason}")
    return merged
