"""The Stage-2 optimizer (port of the Stage-2 part of ``humanliff_tpu/train/optim.py``;
reference improved_diffusion/train_util.py).

The JAX package chains optax transforms (optim.py:90-121), in this order:

1. ``optax.clip(0.5)``: every gradient element clipped to [-0.5, 0.5] (the
   reference's ``clip_grad_value_``); an Inf becomes +-0.5;
2. ``optax.zero_nans()``: NaN elements become 0, nothing else changes;
3. ``optax.clip_by_global_norm(1.0)``: when the global norm is at least 1,
   every element is scaled by 1 / norm; below it nothing changes;
4. ``optax.adamw``: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
   decoupled weight decay, the learning rate read from the schedule at the
   update count before this update (0 at the first).

The port works on one flat fp32 buffer of all parameters and one of their
gradients (``train/stage2.py``), in place, so each stage is a few elementwise
passes over the buffer. ``torch.nan_to_num`` and ``clip_grad_norm_`` are not
used: the first maps +-Inf to +-max float, the second divides by norm + 1e-6
and scales below the threshold as well.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Union

import numpy as np
import torch

OptState = Dict[str, Union[torch.Tensor, int]]


def stage2_lr_schedule(base_lr: float = 5e-5, anneal_steps: int = 0) -> Callable[[int], float]:
    """Linear warm-down to 0 over ``anneal_steps``; constant if 0 (train_util.py:293-304)."""

    def schedule(step: int) -> float:
        if anneal_steps == 0:
            return base_lr
        return base_lr * (1.0 - min(step / anneal_steps, 1.0))

    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in fp32, as optax computes it: at count 1 and b2 =
    0.999, fp32 rounding of the decay moves it by 1.3e-5 relative."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count)))


@dataclass(frozen=True)
class Stage2Optimizer:
    lr: float = 5e-5
    weight_decay: float = 0.0
    anneal_steps: int = 0
    grad_clip_value: float = 0.5  # 0 disables
    grad_clip_norm: float = 1.0  # 0 disables
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: torch.Tensor) -> OptState:
        return {"mu": torch.zeros_like(params), "nu": torch.zeros_like(params), "count": 0}

    def clip_(self, grads: torch.Tensor) -> torch.Tensor:
        """Stages 1-3 in place. The value clip comes first, so that the norm
        clip sees finite values: a norm clip of an Inf gradient would turn it
        into NaN (Inf * 0)."""
        if self.grad_clip_value > 0:
            grads.clamp_(-self.grad_clip_value, self.grad_clip_value)
        grads.masked_fill_(torch.isnan(grads), 0.0)
        if self.grad_clip_norm > 0:
            norm = torch.linalg.vector_norm(grads)
            grads.mul_(torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                                   self.grad_clip_norm / norm))
        return grads

    def step_(self, params: torch.Tensor, grads: torch.Tensor, state: OptState) -> OptState:
        """One update of ``params`` in place from raw ``grads`` (clipped in
        place); returns the new state (moments updated in place)."""
        self.clip_(grads)
        mu, nu, count = state["mu"], state["nu"], int(state["count"])
        lr = stage2_lr_schedule(self.lr, self.anneal_steps)(count)
        mu.mul_(self.b1).add_(grads, alpha=1.0 - self.b1)
        nu.mul_(self.b2).addcmul_(grads, grads, value=1.0 - self.b2)
        count += 1
        denom = (nu / _bias_correction(self.b2, count)).sqrt_().add_(self.eps)
        update = torch.div(mu, _bias_correction(self.b1, count)).div_(denom)
        del denom
        if self.weight_decay:
            update.add_(params, alpha=self.weight_decay)
        params.add_(update, alpha=-lr)
        return {"mu": mu, "nu": nu, "count": count}
