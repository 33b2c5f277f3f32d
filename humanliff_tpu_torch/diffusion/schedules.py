"""Beta schedules (port of ``humanliff_tpu/diffusion/schedules.py``; reference
improved_diffusion/gaussian_diffusion.py:18-62). Host-side numpy, float64."""

from __future__ import annotations

import math

import numpy as np


def betas_for_alpha_bar(num_steps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    betas = []
    for i in range(num_steps):
        t1 = i / num_steps
        t2 = (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def get_named_beta_schedule(schedule_name: str, num_steps: int) -> np.ndarray:
    """'linear' (scaled to any T like the 1000-step DDPM schedule) or 'cosine'."""
    if schedule_name == "linear":
        scale = 1000 / num_steps
        betas = np.linspace(scale * 0.0001, scale * 0.02, num_steps, dtype=np.float64)
        # beta < 1 keeps the constants finite for tiny-T test schedules.
        return np.minimum(betas, 0.999)
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_steps, lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")
