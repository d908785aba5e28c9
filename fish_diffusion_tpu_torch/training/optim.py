"""Optimizers and learning-rate schedules (``fish_diffusion_tpu/training/optim.py``).

The JAX package evaluates an optax schedule at the optimizer's update count
(0 on the first update). ``ScheduledOptimizer`` keeps that convention on a
``torch.optim`` optimizer: before each update it sets the learning rate to
``schedule(count)``. With ``interval="epoch"`` (the GAN trainers: the
reference steps its schedulers once per epoch) the schedule's argument is
``floor(count / steps_per_epoch)``.

Ported: ``AdamW`` (the registry's default ``weight_decay=1e-2``, as optax's
``adamw``: decoupled decay ``p -= lr * wd * p`` beside the Adam update),
``Adam`` (AdamW when it has a weight decay), ``SGD`` (momentum; the decay
added to the gradient), the schedules ``LambdaWarmUpCosineScheduler``,
``LambdaCosineScheduler``, ``StepLR`` and ``ExponentialLR``,
``build_lr_schedule`` and ``build_optimizer`` with its gradient clip and
accumulation:

- the clip by global norm is optax's ``clip_by_global_norm``: the gradients
  become ``g / norm * max_norm`` where ``norm >= max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
- ``accumulate_grad_batches = k`` is ``optax.MultiSteps``: the running mean
  ``acc + (g - acc) / (n + 1)`` of k gradients, then one update of the
  (clipped) mean; the schedule counts updates, not batches.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import math

import torch

from ..registry import LR_SCHEDULERS, OPTIMIZERS


@LR_SCHEDULERS.register_module(name="LambdaWarmUpCosineScheduler")
def warmup_cosine_schedule(val_base: float, val_final: float, max_decay_steps: int,
                           val_start: float = 0.0, warm_up_steps: int = 0):
    """Linear warmup from ``val_start`` to ``val_base`` over
    ``warm_up_steps``, then a cosine from ``val_base`` to ``val_final`` at
    ``max_decay_steps``, constant after."""
    def schedule(step):
        if step < warm_up_steps:
            return (val_base - val_start) / max(warm_up_steps, 1) * step + val_start
        t = min(max((step - warm_up_steps) / max(max_decay_steps - warm_up_steps, 1), 0.0),
                1.0)
        return val_final + 0.5 * (val_base - val_final) * (1 + math.cos(t * math.pi))

    return schedule


@LR_SCHEDULERS.register_module(name="LambdaCosineScheduler")
def cosine_schedule(lr_min: float, lr_max: float, max_decay_steps: int):
    def schedule(step):
        t = min(max(step / max_decay_steps, 0.0), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return schedule


@LR_SCHEDULERS.register_module(name="StepLR")
def step_schedule(step_size: int, gamma: float = 0.1, base_lr: float = 1.0):
    def schedule(step):
        return base_lr * gamma ** math.floor(step / step_size)

    return schedule


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


@OPTIMIZERS.register_module(name="Adam")
def adam(params, learning_rate: float, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay=None) -> torch.optim.Optimizer:
    if weight_decay:
        return adamw(params, learning_rate, weight_decay, betas, eps)
    return torch.optim.Adam(params, lr=learning_rate, betas=tuple(betas), eps=eps)


@OPTIMIZERS.register_module(name="SGD")
def sgd(params, learning_rate: float, momentum: float = 0.0,
        weight_decay=None) -> torch.optim.Optimizer:
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum or 0.0,
                           weight_decay=weight_decay or 0.0)


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of every element together (optax ``global_norm``), as the
    norm of the tensors' norms."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


@torch.no_grad()
def clip_by_global_norm_(tensors, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: each tensor becomes
    ``t / norm * max_norm`` when ``norm >= max_norm`` (divided and multiplied
    by 1 otherwise, so the host never waits for the norm). Returns the
    norm."""
    tensors = list(tensors)
    norm = global_norm(tensors)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(tensors, torch.where(keep, one, norm))
    torch._foreach_mul_(tensors, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer that takes its learning rate from
    ``schedule(count)``, ``count`` being the number of updates it made.
    With ``grad_clip_val`` it clips the gradients by their global norm
    before each update; with ``accumulate`` = k > 1 ``step`` keeps the
    running mean of k gradients and updates on the k-th call."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 grad_clip_val: Optional[float] = None, accumulate: int = 1):
        self.optimizer, self.schedule = optimizer, schedule
        self.grad_clip_val, self.accumulate = grad_clip_val, accumulate
        self.count = 0
        self.mini_step = 0
        self._acc: dict = {}

    def _params(self):
        return [p for group in self.optimizer.param_groups for p in group["params"]
                if p.grad is not None]

    @property
    def lr(self) -> float:
        return self.schedule(self.count)

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Update from the gradients (their running mean over the last
        ``accumulate`` calls); returns False on a call that only
        accumulated."""
        params = self._params()
        if self.accumulate > 1:
            with torch.no_grad():
                for i, p in enumerate(params):
                    acc = self._acc.get(i)
                    if acc is None:
                        self._acc[i] = acc = torch.zeros_like(p.grad)
                    acc.add_((p.grad - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.accumulate:
                return False
            with torch.no_grad():
                for i, p in enumerate(params):
                    p.grad.copy_(self._acc[i])
                    self._acc[i].zero_()
            self.mini_step = 0
        if self.grad_clip_val is not None:
            clip_by_global_norm_([p.grad for p in params], self.grad_clip_val)
        lr = self.lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": dict(self._acc)}

    def load_state_dict(self, state: dict):
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        self._acc = dict(state.get("acc", {}))


def build_optimizer(optimizer_cfg: Dict[str, Any],
                    scheduler_cfg: Optional[Dict[str, Any]] = None,
                    steps_per_epoch: Optional[int] = None,
                    grad_clip_val: Optional[float] = None,
                    accumulate_grad_batches: int = 1):
    """-> ``make(params) -> ScheduledOptimizer`` for the configured
    optimizer and schedule (``steps_per_epoch`` is needed by
    ``interval="epoch"``), clipping by global norm at ``grad_clip_val``
    and accumulating ``accumulate_grad_batches`` gradients an update."""
    cfg = dict(optimizer_cfg)
    base_lr = cfg.pop("lr", 1.0)
    schedule = build_lr_schedule(scheduler_cfg, base_lr, steps_per_epoch)

    def make(params) -> ScheduledOptimizer:
        opt = OPTIMIZERS.build({**cfg, "learning_rate": schedule(0)}, params=params)
        return ScheduledOptimizer(opt, schedule, grad_clip_val, accumulate_grad_batches)

    return make
