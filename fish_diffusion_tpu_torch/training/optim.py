"""Optimizers and learning-rate schedules (``fish_diffusion_tpu/training/optim.py``).

The JAX package evaluates an optax schedule at the optimizer's update count
(0 on the first update). ``ScheduledOptimizer`` keeps that convention on a
``torch.optim`` optimizer: before each update it sets the learning rate to
``schedule(count)``. With ``interval="epoch"`` (the GAN trainers: the
reference steps its schedulers once per epoch) the schedule's argument is
``floor(count / steps_per_epoch)``.

Ported: ``AdamW`` (the registry's default ``weight_decay=1e-2``, as optax's
``adamw``: decoupled decay ``p -= lr * wd * p`` beside the Adam update),
``ExponentialLR``, ``build_lr_schedule`` and ``build_optimizer``. The
vocoder trainer passes no gradient clip, so none is ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..registry import LR_SCHEDULERS, OPTIMIZERS


@LR_SCHEDULERS.register_module(name="ExponentialLR")
def exponential_schedule(gamma: float, base_lr: float = 1.0):
    def schedule(step):
        return base_lr * gamma ** step

    return schedule


def build_lr_schedule(scheduler_cfg: Optional[Dict[str, Any]], base_lr: float,
                      steps_per_epoch: Optional[int] = None) -> Callable[[int], float]:
    """update count -> learning rate: ``base_lr`` times the configured
    factor (``{"type": ..., "interval": "step" | "epoch"}``, or a
    ``LambdaLR`` around one), constant without a scheduler."""
    if scheduler_cfg is None:
        return lambda count: base_lr
    cfg = dict(scheduler_cfg)
    interval = cfg.pop("interval", "step")
    if interval not in ("step", "epoch"):
        raise ValueError(f"scheduler interval must be 'step'/'epoch', got {interval!r}")
    if interval == "epoch" and (not steps_per_epoch or steps_per_epoch < 1):
        raise ValueError("scheduler interval='epoch' requires steps_per_epoch "
                         "(= len(train_loader))")
    if cfg.get("type") == "LambdaLR":
        cfg = dict(cfg["lr_lambda"])
    factor = LR_SCHEDULERS.build(cfg)

    def schedule(count: int) -> float:
        return base_lr * factor(count // steps_per_epoch if interval == "epoch" else count)

    return schedule


@OPTIMIZERS.register_module(name="AdamW")
def adamw(params, learning_rate: float, weight_decay: float = 1e-2,
          betas=(0.9, 0.999), eps: float = 1e-8) -> torch.optim.Optimizer:
    return torch.optim.AdamW(params, lr=learning_rate, betas=tuple(betas),
                             eps=eps, weight_decay=weight_decay)


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer that takes its learning rate from
    ``schedule(count)``, ``count`` being the number of updates it made."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float]):
        self.optimizer, self.schedule = optimizer, schedule
        self.count = 0

    @property
    def lr(self) -> float:
        return self.schedule(self.count)

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        lr = self.lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def build_optimizer(optimizer_cfg: Dict[str, Any],
                    scheduler_cfg: Optional[Dict[str, Any]] = None,
                    steps_per_epoch: Optional[int] = None):
    """-> ``make(params) -> ScheduledOptimizer`` for the configured
    optimizer and schedule (``steps_per_epoch`` is needed by
    ``interval="epoch"``)."""
    cfg = dict(optimizer_cfg)
    base_lr = cfg.pop("lr", 1.0)
    schedule = build_lr_schedule(scheduler_cfg, base_lr, steps_per_epoch)

    def make(params) -> ScheduledOptimizer:
        opt = OPTIMIZERS.build({**cfg, "learning_rate": schedule(0)}, params=params)
        return ScheduledOptimizer(opt, schedule)

    return make
