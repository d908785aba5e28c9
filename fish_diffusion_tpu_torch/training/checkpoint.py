"""Checkpoints of the GAN training state (``fish_diffusion_tpu/training/checkpoint.py``).

One ``torch.save`` file per step, ``<directory>/<step>.pt``, holding the
step, both parameter sets, the spectral-norm state, both optimizers (with
their update counts) and the metrics of the step. Resume restores the
latest. A step that a previous run left in the directory is overwritten,
never kept: keeping it would hand ``restore`` the old run's parameters
while this run reports the step as saved.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch


class CheckpointManager:
    def __init__(self, directory):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._written_steps: set = set()  # saved by this manager

    def _path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def all_steps(self):
        return sorted(int(p.stem) for p in self.directory.glob("*.pt")
                      if p.stem.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, metrics: Optional[dict] = None):
        """Write ``state`` at ``state.step``, unless this manager already
        wrote that step."""
        step = int(state.step)
        if step in self._written_steps:
            return
        payload = {
            "step": step,
            "params_g": state.params_g.state_dict(),
            "params_d": state.params_d.state_dict(),
            "spectral_d": dict(state.spectral_d),
            "opt_state_g": state.opt_state_g.state_dict(),
            "opt_state_d": state.opt_state_d.state_dict(),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        path = self._path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)  # a previous run's file at this step is replaced
        self._written_steps.add(step)

    def restore(self, state, step: Optional[int] = None):
        """Load the checkpoint at ``step`` (default the latest) into
        ``state`` in place and return it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.params_g.load_state_dict(payload["params_g"])
        state.params_d.load_state_dict(payload["params_d"])
        device = next(state.params_g.parameters()).device
        state.spectral_d = {k: v.to(device) for k, v in payload["spectral_d"].items()}
        state.opt_state_g.load_state_dict(payload["opt_state_g"])
        state.opt_state_d.load_state_dict(payload["opt_state_d"])
        state.step = int(payload["step"])
        return state
