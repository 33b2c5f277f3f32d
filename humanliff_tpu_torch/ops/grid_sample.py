"""Bilinear 2D grid sampling of one channels-last map (port of
``humanliff_tpu/ops/grid_sample.py``).

The JAX module writes ``F.grid_sample``'s semantics out in gathers for the
TPU; here they are ``F.grid_sample`` itself, in the configuration the
reference uses for the tri-plane lookup (recon_NeRF/lib/renderer.py:537-545):
bilinear, ``align_corners=False`` (-1 and +1 are the outer edges of the
border texels), zeros outside the map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``image`` (H, W, C) at ``grid`` (M, 2) normalized coordinates,
    ``grid[:, 0]`` along the width (x) and ``grid[:, 1]`` along the height
    (y), both in [-1, 1]: returns (M, C), zero outside the image."""
    out = F.grid_sample(image.permute(2, 0, 1)[None], grid[None, None].to(image.dtype),
                        mode="bilinear", padding_mode="zeros", align_corners=False)
    return out[0, :, 0].transpose(0, 1)  # (1, C, 1, M) -> (M, C)
