"""Timestep samplers for training (port of ``humanliff_tpu/diffusion/resample.py``;
reference improved_diffusion/resample.py).

The loss-aware sampler is functional, as in the JAX package: its state (a ring
buffer of recent losses per timestep, and their counts) is a dict of tensors
that the train step passes in and gets back, kept on the step's device.
Timesteps are drawn from a ``torch.Generator``: JAX's key splits cannot be
reproduced, so parity tests inject the JAX draws into the train step instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

SamplerState = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class UniformSampler:
    num_timesteps: int

    def sample(self, batch: int, device, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = torch.randint(0, self.num_timesteps, (batch,), generator=generator, device=device)
        return t, torch.ones(batch, device=device)


@dataclass(frozen=True)
class LossSecondMomentResampler:
    """Importance-sample timesteps by sqrt E[loss^2] (resample.py:70-154)."""

    num_timesteps: int
    history_per_term: int = 10
    uniform_prob: float = 0.001

    def init_state(self, device="cpu") -> SamplerState:
        return {
            "history": torch.zeros(self.num_timesteps, self.history_per_term, device=device),
            "counts": torch.zeros(self.num_timesteps, dtype=torch.int32, device=device),
        }

    def _weights(self, state: SamplerState) -> torch.Tensor:
        """Uniform until every timestep holds a full history, then proportional
        to the RMS of its losses; a share ``uniform_prob`` always stays uniform."""
        warmed = torch.all(state["counts"] == self.history_per_term)
        w = torch.sqrt(torch.mean(state["history"] ** 2, dim=-1))
        w = torch.where(warmed, w, torch.ones_like(w))
        p = w / w.sum()
        return p * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps

    def sample(self, state: SamplerState, batch: int,
               generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        p = self._weights(state)
        t = torch.multinomial(p, batch, replacement=True, generator=generator)
        return t, 1.0 / (self.num_timesteps * p[t])

    def update(self, state: SamplerState, t: torch.Tensor, losses: torch.Tensor) -> SamplerState:
        """Insert per-example losses into the per-timestep ring buffers, one
        example at a time in batch order: a timestep drawn twice in one batch
        takes both losses, oldest first (a single scatter would keep one)."""
        history, counts = state["history"].clone(), state["counts"].clone()
        H = self.history_per_term
        losses = losses.detach().to(history.dtype)
        for i in range(t.shape[0]):
            ti = t[i:i + 1]
            count = counts.index_select(0, ti)
            row = history.index_select(0, ti)[0]
            shifted = torch.cat([row[1:], losses[i:i + 1]])
            appended = row.scatter(0, count.clamp(max=H - 1).long(), losses[i:i + 1])
            history.index_copy_(0, ti, torch.where(count == H, shifted, appended)[None])
            counts.index_copy_(0, ti, (count + 1).clamp(max=H))
        return {"history": history, "counts": counts}


def create_named_schedule_sampler(name: str, num_timesteps: int):
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
