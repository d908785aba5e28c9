"""Train state and step of the diffusion regime (``fish_diffusion_tpu/training/state.py``).

- ``TrainState``: the step, the model (its parameters), the optimizer with
  its update count, and the EMA copy of the model when ``ema_momentum`` is
  set; ``inference_params`` is the EMA model when there is one.
- ``make_train_step``: loss, backward, the global norm of the gradients
  (reported as ``grad_norm``, before the clip), the optimizer's clip and
  update (``training/optim.py``), then the EMA ``e * m + p * (1 - m)`` from
  the updated parameters.

The JAX step's mesh, sharding and buffer donation have no counterpart: the
port trains on one card, and updates the parameters in place.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .optim import ScheduledOptimizer, global_norm

# Batch keys forwarded to the model, as the JAX step forwards them
_MODEL_KEYS = ("speakers", "contents", "contents_lens", "mel", "mel_lens", "pitches",
               "pitch_shift", "energy")
_INT_KEYS = ("speakers", "contents_lens", "mel_lens")


def model_kwargs(batch: Dict) -> Dict:
    """The model's arguments from a batch (``speaker`` and ``key_shift``
    taken for ``speakers`` and ``pitch_shift``, as the JAX step does)."""
    kwargs = {k: batch[k] for k in _MODEL_KEYS if k in batch}
    if "speaker" in batch and "speakers" not in kwargs:
        kwargs["speakers"] = batch["speaker"]
    if "key_shift" in batch and "pitch_shift" not in kwargs:
        kwargs["pitch_shift"] = batch["key_shift"]
    return kwargs


def batch_to_device(batch: Dict, device) -> Dict:
    """The numeric entries of a collated batch as tensors on ``device``
    (float32, integer ids and lengths int64); paths and the ``*_max_len``
    scalars are dropped, the shapes carry them."""
    out = {}
    for key, value in batch.items():
        if key == "path" or key.endswith("_max_len"):
            continue
        arr = np.asarray(value)
        if arr.dtype.kind not in "fiub":
            continue
        t = torch.as_tensor(arr)
        t = t.long() if key in _INT_KEYS or key == "speaker" else t.float()
        if torch.device(device).type == "cuda":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: ScheduledOptimizer
    ema: Optional[nn.Module] = None

    def inference_params(self) -> nn.Module:
        """The EMA model if enabled, else the live model."""
        return self.ema if self.ema is not None else self.model


def create_train_state(model: nn.Module, make_optimizer: Callable,
                       ema_momentum: Optional[float] = None) -> TrainState:
    """Step 0, an optimizer over the parameters that take gradients, and an
    EMA copy of the model when ``ema_momentum`` is set."""
    optimizer = make_optimizer([p for p in model.parameters() if p.requires_grad])
    ema = None
    if ema_momentum:
        ema = copy.deepcopy(model)
        ema.requires_grad_(False)
    return TrainState(step=0, model=model, optimizer=optimizer, ema=ema)


@torch.no_grad()
def ema_update_(ema: nn.Module, model: nn.Module, momentum: float) -> None:
    """``e * m + p * (1 - m)`` for every parameter that trains (a frozen
    one's average stays its value)."""
    for e, p in zip(ema.parameters(), model.parameters()):
        if p.requires_grad:
            e.copy_(e * momentum + p * (1.0 - momentum))


def make_train_step(ema_momentum: Optional[float] = None) -> Callable:
    """``train_step(state, batch, generator=None, t=None, noise=None) ->
    (state, {"loss", "grad_norm"})``. ``batch`` holds device tensors
    (``batch_to_device``); t and the noise come from ``generator`` unless
    passed in (``DiffSinger.forward``)."""

    def train_step(state: TrainState, batch: Dict, generator=None, t=None, noise=None):
        out = state.model(**model_kwargs(batch), generator=generator, t=t, noise=noise)
        loss = out["loss"]
        state.optimizer.zero_grad()
        loss.backward()
        grad_norm = global_norm([p.grad for p in state.model.parameters()
                                 if p.grad is not None])
        state.optimizer.step()
        if state.ema is not None:
            ema_update_(state.ema, state.model, ema_momentum)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm.detach()}

    return train_step
