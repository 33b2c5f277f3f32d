"""Tri-plane visualisation (port of ``humanliff_tpu/sampling/viz.py``).

``triplane_to_rgb`` mirrors the reference's ``Renderer.to_rgb`` debug view
(renderer.py:297-302): a fixed random 1x1 colour projection of each plane's
feature channels, min-max normalised, the three planes side by side. The
projection comes from a ``torch.Generator`` seeded with ``seed``, so one seed
gives other colours than the JAX function's ``jax.random`` draw;
:func:`colorize_planes` takes the colour matrix, the same map given the same
matrix.
"""

from __future__ import annotations

import numpy as np
import torch


def colorize_planes(planes: torch.Tensor, colorize: torch.Tensor) -> np.ndarray:
    """(3, C3, D, D) or (C, D, D) planes and a (3, C // 3) colour matrix ->
    (D, 3 * D, 3) uint8: each plane's channels projected to RGB by
    ``colorize``, scaled to [-1, 1] by its own min and max."""
    p = torch.as_tensor(planes, dtype=torch.float32)
    p = p.reshape(-1, *p.shape[-2:])  # (C, D, D)
    per_plane = p.shape[0] // 3
    colorize = torch.as_tensor(colorize, dtype=torch.float32).to(p.device)
    tiles = []
    for i in range(3):
        img = torch.einsum("rc,cij->ijr", colorize, p[i * per_plane:(i + 1) * per_plane])
        lo, hi = img.min(), img.max()
        tiles.append(2.0 * (img - lo) / torch.clamp(hi - lo, min=1e-8) - 1.0)
    out = torch.cat(tiles, dim=1)  # (D, 3D, 3)
    return ((out * 0.5 + 0.5) * 255).cpu().numpy().astype(np.uint8)


def triplane_to_rgb(planes: torch.Tensor, seed: int = 0) -> np.ndarray:
    """:func:`colorize_planes` with a (3, C // 3) N(0, 1) colour matrix drawn
    from ``torch.Generator().manual_seed(seed)`` on the CPU."""
    per_plane = int(np.prod(planes.shape[:-2])) // 3
    colorize = torch.randn(3, per_plane, generator=torch.Generator().manual_seed(seed))
    return colorize_planes(planes, colorize)
