"""Diffusion noise schedules (``fish_diffusion_tpu/ops/schedule.py``, a
copy). Host-side numpy float64.
"""

from __future__ import annotations

import numpy as np


def get_noise_schedule_list(
    schedule_mode: str, timesteps: int, max_beta: float = 0.01, s: float = 0.008
) -> np.ndarray:
    if schedule_mode == "linear":
        schedule_list = np.linspace(1e-4, max_beta, timesteps)
    elif schedule_mode == "cosine":
        steps = timesteps + 1
        x = np.linspace(0, steps, steps)
        alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
        alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
        betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
        schedule_list = np.clip(betas, a_min=0, a_max=0.999)
    else:
        raise NotImplementedError(schedule_mode)

    return schedule_list
