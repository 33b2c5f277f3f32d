"""Alpha compositing along rays (port of ``humanliff_tpu/ops/compositing.py``).

Keeps the reference quirks: the fine-pass alpha uses raw z-interval widths (not
scaled by ``||d||``) and the transmittance epsilon is 1e-7.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from humanliff_tpu_torch.ops.fused_decoder import softplus


def volume_weights(
    densities: torch.Tensor,
    z_vals: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Compositing weights ``(..., R, S)`` from raw densities; a generator adds
    the training-time N(0, 1) density noise (renderer.py:221)."""
    if generator is not None:
        densities = densities + torch.randn(
            densities.shape, generator=generator, dtype=densities.dtype,
            device=densities.device,
        )
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-softplus(densities) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-7], dim=-1), dim=-1
    )[..., :-1]
    return alpha * trans


def composite_rays(
    rgb: torch.Tensor,
    densities: torch.Tensor,
    z_vals: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    white_bkgd: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rgb_map ``(..., R, 3)``, acc_map ``(..., R)``, un-normalized depth ``(..., R)``)."""
    weights = volume_weights(densities, z_vals, generator=generator)
    acc_map = weights.sum(dim=-1)
    rgb_map = (rgb * weights[..., None]).sum(dim=-2)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    depth_map = (weights * z_vals).sum(dim=-1)
    return rgb_map, acc_map, depth_map
