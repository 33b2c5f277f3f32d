"""NN helpers for the UNet (port of ``humanliff_tpu/models/nn.py``; reference
improved_diffusion/nn.py)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embeddings in fp32, ``[cos | sin]`` layout (nn.py:103-121).
    Timesteps may be fractional (rescaled)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) computed in fp32 whatever the activation dtype (nn.py:17-19).

    The JAX package's ``optimization_barrier`` at B=2/4 is an identity and is
    not ported.
    """

    def __init__(self, channels: int, num_groups: int = 32):
        groups = min(num_groups, channels)
        if channels % groups:  # only in non-reference channel configs
            groups = math.gcd(channels, groups)
        super().__init__(groups, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(
            x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps
        ).to(x.dtype)


def zero_module(module: nn.Module) -> nn.Module:
    """Zero a module's parameters (the reference's ``zero_module``, nn.py:68-74)."""
    for p in module.parameters():
        p.detach().zero_()
    return module
