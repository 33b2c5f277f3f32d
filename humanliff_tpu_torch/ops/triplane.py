"""Nine-plane tri-plane feature sampling (port of ``humanliff_tpu/ops/triplane.py``).

Planes are ``(3, C3, D, D)`` (or batched ``(B, 3, C3, D, D)``) with ``C3 = 9``.
Each plane splits its channels into three groups of ``C = C3 // 3``: group 0
samples at the projected coordinate, group 1 at +1/D along grid-x and group 2
at +1/D along grid-y (+0.5 px under ``align_corners=False``), giving nine
feature maps (reference renderer.py:520-549). The three planes take the
coordinate pairs (x, y), (x, z), (z, y). Bilinear, zeros padding. The output
27-vector is plane-major: ``[p0_g0, p0_g1, p0_g2, p1_g0, ..., p2_g2]``.

This is the plain form, one ``F.grid_sample`` per group; the JAX package's
quad-packed tables were a workaround for the TPU's gather. Sampling runs in
fp32 whatever the planes' dtype (JAX's fp32 lerp weights promote bf16 planes).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

PLANE_COORD_IDX = ((0, 1), (0, 2), (2, 1))
_GROUP_OFFSETS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0))  # in units of 1/D


def normalize_to_box(coords: torch.Tensor, box_warp: torch.Tensor) -> torch.Tensor:
    """``2 (c - lo) / (hi - lo) - 1`` for a ``(2, 3)`` (or ``(B, 2, 3)``) AABB."""
    lo = box_warp[..., 0:1, :]
    hi = box_warp[..., 1:2, :]
    return 2.0 * (coords - lo) / (hi - lo) - 1.0


def sample_triplane_features(
    planes: torch.Tensor,
    coords: torch.Tensor,
    box_warp: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(M, 27)`` fp32 features at ``coords`` ``(M, 3)``; batched ``(B, M, 27)``.

    ``coords`` are world points when ``box_warp`` is given, else already in [-1, 1].
    """
    if planes.dim() == 4:
        return sample_triplane_features(
            planes[None], coords[None], None if box_warp is None else box_warp[None]
        )[0]
    B, n_planes, C3, D, _ = planes.shape
    if n_planes != 3 or C3 % 3:
        raise ValueError(f"planes must be (B, 3, 3k, D, D), got {tuple(planes.shape)}")
    C = C3 // 3
    M = coords.shape[1]
    c = coords.float()
    if box_warp is not None:
        c = normalize_to_box(c, box_warp.float().to(c.device))
    planes = planes.float()
    # (B, 3, M, 2) projected grid coordinates, (x, y), (x, z), (z, y).
    proj = torch.stack([c[..., list(pair)] for pair in PLANE_COORD_IDX], dim=1)
    feats = []
    for g, (dx, dy) in enumerate(_GROUP_OFFSETS):
        grid = proj + proj.new_tensor([dx / D, dy / D])
        maps = planes[:, :, g * C:(g + 1) * C].reshape(B * 3, C, D, D)
        out = F.grid_sample(
            maps, grid.reshape(B * 3, 1, M, 2), mode="bilinear",
            padding_mode="zeros", align_corners=False,
        )  # (B*3, C, 1, M)
        feats.append(out.reshape(B, 3, C, M))
    # (B, plane, group, C, M) -> (B, M, plane, group, C) -> (B, M, 27), contiguous
    # (the decoder kernel takes row-major features).
    f = torch.stack(feats, dim=2).permute(0, 4, 1, 2, 3)
    return f.reshape(B, M, 3 * C3).contiguous()
