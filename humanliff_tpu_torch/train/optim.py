"""The optimizers of both stages (port of ``humanliff_tpu/train/optim.py``).

Stage 1 (reference run_nerf_batch.py:89, :281-297): two Adam groups, the
shared decoder (lr 5e-3, ``0.1^(step / (lrate_decay * 600))``) and the
tri-plane table (lr 1e-1, ``0.5^(step / (lrate_decay * 60))``), both
schedules frozen after step 300k; the fine-tune (run_nerf_batch_ft.py:124-129,
:294-299) freezes the decoder and halves the plane lr every 500 steps. As
optax's ``adam`` computes it: each schedule is read at the update count
before the update, the bias corrections use count + 1 in fp32, and eps is
outside the square root. The Adam is dense: every element of the plane
table moves by its moments each step, whether this batch touched it or not.

Stage 2 (reference improved_diffusion/train_util.py): the JAX package chains
optax transforms (optim.py:90-121), in this order:

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
from typing import Callable, Dict, Optional, Union

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


def adam_step_(params: torch.Tensor, grads: torch.Tensor, state: OptState, lr: float,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0) -> OptState:
    """One optax Adam(W) update of ``params`` in place from ``grads`` at
    learning rate ``lr``; the moments update in place and the new state is
    returned."""
    mu, nu, count = state["mu"], state["nu"], int(state["count"])
    mu.mul_(b1).add_(grads, alpha=1.0 - b1)
    nu.mul_(b2).addcmul_(grads, grads, value=1.0 - b2)
    count += 1
    denom = (nu / _bias_correction(b2, count)).sqrt_().add_(eps)
    update = torch.div(mu, _bias_correction(b1, count)).div_(denom)
    del denom
    if weight_decay:
        update.add_(params, alpha=weight_decay)
    params.add_(update, alpha=-lr)
    return {"mu": mu, "nu": nu, "count": count}


def _exp_decay(base_lr: float, rate: float, decay_steps: int,
               cap: Optional[int] = None) -> Callable[[int], float]:
    """``base_lr * rate^(min(step, cap) / decay_steps)`` in fp32, as JAX
    evaluates it."""

    def schedule(step: int) -> float:
        s = np.float32(step if cap is None else min(step, cap)) / np.float32(decay_steps)
        return float(np.float32(base_lr) * np.power(np.float32(rate), s))

    return schedule


def stage1_decoder_schedule(base_lr: float, lrate_decay: int = 500) -> Callable[[int], float]:
    """``base_lr * 0.1^(min(step, 300k) / (lrate_decay * 600))``."""
    return _exp_decay(base_lr, 0.1, lrate_decay * 600, cap=300_000)


def stage1_plane_schedule(base_lr: float, lrate_decay: int = 500) -> Callable[[int], float]:
    """``base_lr * 0.5^(min(step, 300k) / (lrate_decay * 60))``."""
    return _exp_decay(base_lr, 0.5, lrate_decay * 60, cap=300_000)


def finetune_plane_schedule(plane_lr: float = 1e-1,
                            decay_every: int = 500) -> Callable[[int], float]:
    """``plane_lr * 0.5^(step / decay_every)`` (run_nerf_batch_ft.py:294-299)."""
    return _exp_decay(plane_lr, 0.5, decay_every)


@dataclass(frozen=True)
class Stage1Optimizer:
    """Two Adam groups over ``{"planes", "decoder"}`` tensors (b1 0.9, b2
    0.999, eps 1e-8). ``decoder_schedule=None`` is optax's ``set_to_zero``
    for the decoder: it keeps no state and its tensor is not touched."""

    plane_schedule: Callable[[int], float]
    decoder_schedule: Optional[Callable[[int], float]] = None

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Optional[OptState]]:
        def adam(p):
            return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p), "count": 0}

        return {"planes": adam(params["planes"]),
                "decoder": None if self.decoder_schedule is None else adam(params["decoder"])}

    def step_(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict[str, Optional[OptState]]) -> Dict[str, Optional[OptState]]:
        """Update ``params`` in place (under ``no_grad``); returns the new state."""
        out = dict(state)
        with torch.no_grad():
            for name, schedule in (("planes", self.plane_schedule),
                                   ("decoder", self.decoder_schedule)):
                if schedule is None:
                    continue
                st = state[name]
                out[name] = adam_step_(params[name], grads[name], st,
                                       schedule(int(st["count"])))
        return out


def make_stage1_optimizer(decoder_lr: float = 5e-3, plane_lr: float = 1e-1,
                          lrate_decay: int = 500,
                          freeze_decoder: bool = False) -> Stage1Optimizer:
    """Stage 1's two-group Adam; ``freeze_decoder`` is the fine-tune mode
    (run_nerf_batch_ft.py:124-129) in which only the planes update."""
    return Stage1Optimizer(
        plane_schedule=stage1_plane_schedule(plane_lr, lrate_decay),
        decoder_schedule=None if freeze_decoder else stage1_decoder_schedule(decoder_lr,
                                                                             lrate_decay))


def make_finetune_optimizer(plane_lr: float = 1e-1, decay_every: int = 500) -> Stage1Optimizer:
    """The fine-tune optimizer: decoder frozen, plane lr halving every
    ``decay_every`` steps."""
    return Stage1Optimizer(plane_schedule=finetune_plane_schedule(plane_lr, decay_every))


def clamp_planes_(planes: torch.Tensor, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    """The post-update clamp of the whole tri-plane table, in place
    (run_nerf_batch.py:271-272)."""
    with torch.no_grad():
        return planes.clamp_(lo, hi)


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
        lr = stage2_lr_schedule(self.lr, self.anneal_steps)(int(state["count"]))
        return adam_step_(params, grads, state, lr, self.b1, self.b2, self.eps,
                          self.weight_decay)
