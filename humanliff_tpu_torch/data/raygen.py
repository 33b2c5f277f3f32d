"""Host-side rays of the loaders (port of ``humanliff_tpu/data/raygen.py``; its
``get_rays_np`` and ``get_near_far_np`` are ``ops/rays.py``'s ``get_rays`` and
``intersect_aabb``), mirroring recon_NeRF/lib/if_nerf_data_utils.py: full-image
eval rays, the projected-box mask, and body/background-weighted training rays
at ratio 0.8 with the rejection loop that refills until exactly N rays hit the
box (:87-170).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from humanliff_tpu_torch.ops.rays import get_rays, intersect_aabb

_BOX_FACES = ([0, 1, 3, 2, 0], [4, 5, 7, 6, 4], [0, 1, 5, 4, 0],
              [2, 3, 7, 6, 2], [0, 2, 6, 4, 0], [1, 3, 7, 5, 1])


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


def get_bound_2d_mask(bounds, K, pose, H: int, W: int) -> np.ndarray:
    """(H, W) uint8 mask of the 3D box projected by K and the (3, 4) ``pose``,
    its six faces filled by ``cv2.fillPoly`` (if_nerf_data_utils.py:36-47).
    Without OpenCV every pixel is in, as in the JAX package."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    (min_x, min_y, min_z), (max_x, max_y, max_z) = bounds[0], bounds[1]
    corners = np.array([
        [min_x, min_y, min_z], [min_x, min_y, max_z], [min_x, max_y, min_z],
        [min_x, max_y, max_z], [max_x, min_y, min_z], [max_x, min_y, max_z],
        [max_x, max_y, min_z], [max_x, max_y, max_z],
    ])
    pts = (corners @ pose[:, :3].T + pose[:, 3:].T) @ K.T
    c2d = np.round(pts[:, :2] / pts[:, 2:]).astype(int)
    mask = np.zeros((H, W), dtype=np.uint8)
    if cv2 is None:
        return mask + 1
    for face in _BOX_FACES:
        cv2.fillPoly(mask, [c2d[face]], 1)
    return mask


def sample_ray_batch_train(img: np.ndarray, msk: np.ndarray, K, R, T, bounds, n_rays: int,
                           body_ratio: float = 0.8,
                           rng: np.random.Generator | None = None) -> dict:
    """Exactly ``n_rays`` box-hitting rays, ``body_ratio`` of each draw from
    the mask's pixels inside the projected box, the rest from its background
    there. Returns rgb (N, 3), ray_o, ray_d, near, far, bkgd (N,) and
    ray_mask (N,) of ones, fp32."""
    rng = rng or np.random.default_rng()
    H, W = img.shape[:2]
    ray_o, ray_d = get_rays(H, W, K, R, T)
    bound_mask = get_bound_2d_mask(bounds, K, np.concatenate([R, T.reshape(3, 1)], axis=1),
                                   H, W)
    msk = msk * bound_mask
    img = img.copy()
    img[bound_mask != 1] = 0

    body_coords = np.argwhere(msk == 1)
    bg_coords = np.argwhere((bound_mask == 1) & (msk != 1))
    if len(body_coords) == 0:
        body_coords = bg_coords
    if len(bg_coords) == 0:
        bg_coords = body_coords

    out = {k: [] for k in ("rgb", "ray_o", "ray_d", "near", "far", "bkgd")}
    n_collected = 0
    while n_collected < n_rays:
        want = n_rays - n_collected
        n_body = int(want * body_ratio)
        cb = body_coords[rng.integers(0, len(body_coords), n_body)]
        cg = bg_coords[rng.integers(0, len(bg_coords), want - n_body)]
        coords = np.concatenate([cb, cg], axis=0)
        bkgd = np.concatenate([np.ones(len(cb), np.float32), np.zeros(len(cg), np.float32)])
        ro = ray_o[coords[:, 0], coords[:, 1]]
        rd = ray_d[coords[:, 0], coords[:, 1]]
        near, far, hit = intersect_aabb(bounds, ro, rd)
        for k, v in (("rgb", img[coords[:, 0], coords[:, 1]]), ("ray_o", ro), ("ray_d", rd),
                     ("near", near), ("far", far), ("bkgd", bkgd)):
            out[k].append(v[hit])
        n_collected += int(hit.sum())

    res = {k: np.concatenate(v)[:n_rays].astype(np.float32) for k, v in out.items()}
    res["ray_mask"] = np.ones((n_rays,), np.float32)
    return res


def unproject_depth(depth: np.ndarray, K, R, T) -> np.ndarray:
    """A depth map's pixels as world points (H, W, 3) (if_nerf_data_utils.py:204-213)."""
    H, W = depth.shape
    i, j = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32),
                       indexing="xy")
    xyz = np.stack([i, j, np.ones_like(i)], axis=2) * depth[..., None]
    return (xyz @ np.linalg.inv(K).T - np.asarray(T).ravel()) @ R
