"""Ray-depth sampling (port of ``humanliff_tpu/ops/sampling.py``).

Stratified coarse depths and inverse-CDF fine depths (reference
renderer.py:166-178, :551-581). Randomness comes from an explicit
``torch.Generator``; ``None`` means the deterministic eval path.
"""

from __future__ import annotations

from typing import Optional

import torch

from humanliff_tpu_torch.ops.fused_decoder import softplus


def _uniform(shape, like: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def stratified_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """``(..., n_samples)`` depths evenly spaced in [near, far], jittered per
    interval when a generator is given (run_nerf_batch.py:46-55)."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    z = near[..., None] * (1.0 - t) + far[..., None] * t
    if generator is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        z = lower + (upper - lower) * _uniform(z.shape, z, generator)
    return z


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` depths from a piecewise-constant pdf.

    ``bins`` ``(..., B)``, ``weights`` ``(..., B-1)``. ``searchsorted(right=True)``
    and the denom < 1e-5 guard as in renderer.py:551-581; linspace ``u`` when
    ``generator`` is None. ``right=True`` counts the cdf entries <= u, the same
    bin as the JAX compare-all prefix sum, ties included.
    """
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (..., B)

    u_shape = cdf.shape[:-1] + (n_samples,)
    if generator is None:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(u_shape).contiguous()
    else:
        u = _uniform(u_shape, cdf, generator)

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def coarse_weights(densities: torch.Tensor, z_vals: torch.Tensor,
                   rays_d: torch.Tensor) -> torch.Tensor:
    """Compositing weights ``(..., R, S)`` of raw coarse densities as the
    up-sampler sees them: z widths scaled by ``||d||`` (renderer.py:171), a
    1e10 tail interval and transmittance epsilon 1e-10."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1)[..., None]
    alpha = 1.0 - torch.exp(-softplus(densities) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1), dim=-1
    )[..., :-1]
    return alpha * trans


def upsample_z_vals(
    densities: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    n_importance: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Importance-sample ``n_importance`` new depths (unsorted) from raw coarse
    densities ``(..., R, S)`` weighted by :func:`coarse_weights`."""
    weights = coarse_weights(densities, z_vals, rays_d)
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    return sample_pdf(z_mid, weights[..., 1:-1], n_importance, generator=generator)


def merge_z_vals(z_vals: torch.Tensor, new_z_vals: torch.Tensor) -> torch.Tensor:
    """Concatenate coarse and fine depths and sort (renderer.py:268-269)."""
    return torch.sort(torch.cat([z_vals, new_z_vals], dim=-1), dim=-1).values
