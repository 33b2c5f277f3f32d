"""Camera rays and the ray-AABB test, host-side numpy.

Port of ``humanliff_tpu/ops/rays.py`` in its numpy form
(``humanliff_tpu/data/raygen.py::get_rays_np, get_near_far_np``): rays are made
once per view on the host and uploaded once, so they stay numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def get_rays(H: int, W: int, K, R, T) -> Tuple[np.ndarray, np.ndarray]:
    """Pinhole rays ``(H, W, 3)``: un-normalized directions, origin ``-R^T T``."""
    rays_o = -np.dot(R.T, T).ravel()
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = np.dot(xy1, np.linalg.inv(K).T)
    pixel_world = np.dot(pixel_camera - T.ravel(), R)
    rays_d = pixel_world - rays_o[None, None]
    return np.broadcast_to(rays_o, rays_d.shape).copy(), rays_d


def intersect_aabb(bounds, ray_o, ray_d, pad: float = 0.01):
    """Exactly-two-hits AABB test of the reference (if_nerf_data_utils.py:50-85).

    Returns (near, far, mask), each ``(N,)``; near/far are zero off the box.
    """
    bounds = bounds + np.array([-pad, pad])[:, None]
    d = ray_d.copy()
    d[d == 0.0] = 1e-8
    t_hit = ((bounds[None] - ray_o[:, None]) / d[:, None]).reshape(-1, 6)
    p_hit = t_hit[..., None] * d[:, None] + ray_o[:, None]
    eps = 1e-6
    on_box = np.all((p_hit >= bounds[0] - eps) & (p_hit <= bounds[1] + eps), axis=-1)
    mask = on_box.sum(-1) == 2
    big = np.finfo(np.float64).max
    tmin = np.where(on_box, t_hit, big).min(-1)
    tmax = np.where(on_box, t_hit, -big).max(-1)
    d0, d1 = np.abs(tmin), np.abs(tmax)
    near = np.where(mask, np.minimum(d0, d1), 0.0).astype(np.float32)
    far = np.where(mask, np.maximum(d0, d1), 0.0).astype(np.float32)
    return near, far, mask
