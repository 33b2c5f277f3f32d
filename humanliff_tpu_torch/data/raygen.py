"""Full-image eval rays (port of ``humanliff_tpu/data/raygen.py::full_image_rays``;
its ``get_rays_np`` and ``get_near_far_np`` are ``ops/rays.py``'s ``get_rays``
and ``intersect_aabb``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from humanliff_tpu_torch.ops.rays import get_rays, intersect_aabb


def full_image_rays(
    H: int, W: int, K, R, T, bounds
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Rays for every pixel, near=0/far=1 off the box (if_nerf_data_utils.py:172-189).

    Returns (ray_o (N, 3), ray_d (N, 3), near (N,), far (N,), mask_at_box (N,)).
    """
    ray_o, ray_d = get_rays(H, W, K, R, T)
    ray_o = ray_o.reshape(-1, 3).astype(np.float32)
    ray_d = ray_d.reshape(-1, 3).astype(np.float32)
    near, far, mask = intersect_aabb(bounds, ray_o, ray_d)
    near_all = np.zeros_like(ray_o[:, 0])
    far_all = np.ones_like(ray_o[:, 0])
    near_all[mask] = near[mask]
    far_all[mask] = far[mask]
    return ray_o, ray_d, near_all, far_all, mask
