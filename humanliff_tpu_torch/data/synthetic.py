"""Synthetic layered-human stand-in data for smoke tests and benchmarking.

Generates multi-view renders of procedurally-layered "bodies" (nested soft
ellipsoids — one more shell per clothing layer) with analytic ground truth, so the
full stage-1 pipeline can run end-to-end without the SynBody/TightCap assets.

A copy of ``humanliff_tpu/data/synthetic.py`` (numpy only, the same
arithmetic and ``default_rng(1234)``), so an item is bit for bit the JAX
package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from humanliff_tpu_torch.data.raygen import full_image_rays
from humanliff_tpu_torch.ops.rays import get_rays, intersect_aabb


def _ellipsoid_density(pts: np.ndarray, center, radii, sharpness=40.0):
    d = np.square((pts - center) / radii).sum(-1)
    # Clamp the logit: float32 exp overflows past ~88 (the fp64 original never
    # hit this); the clamped tail is exactly 0/1 at fp32 anyway.
    return 1.0 / (1.0 + np.exp(np.minimum(sharpness * (d - 1.0), 80.0)))


@dataclass
class SyntheticLayeredDataset:
    """Indexable item source emitting the stage-1 batch schema (world space).

    ``tight_bounds=True`` uses per-instance AABBs hugging the outermost shell
    (+0.05 pad) instead of the loose [-1, 1]^3 box — the analog of the real
    loaders' vertex bounds (SynBody_dataset.py:188-194); tri-plane texels then
    cover the body instead of empty space, which matters for quality parity.
    """

    num_instances: int = 2
    num_layers: int = 4
    n_rays: int = 512
    image_size: int = 64
    n_gt_samples: int = 96  # quadrature samples for analytic GT ray marching
    tight_bounds: bool = False

    def __post_init__(self):
        import threading

        rng = np.random.default_rng(1234)
        # Per-instance base shape + per-layer shell colors (fp32: the GT
        # quadrature is memory-bandwidth-bound; fp64 temporaries double it).
        self.centers = rng.uniform(
            -0.15, 0.15, size=(self.num_instances, 3)
        ).astype(np.float32)
        self.base_radii = rng.uniform(
            0.25, 0.4, size=(self.num_instances, 3)
        ).astype(np.float32)
        self.colors = rng.uniform(
            0.2, 1.0, size=(self.num_instances, self.num_layers, 3)
        ).astype(np.float32)
        self.bounds = np.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
        # (inst, layer, view) -> full-view GT rays: computed once, then every
        # item() is a cheap weighted ray selection. Without this the loader
        # workers (GIL-bound threads) starve the TPU ~10x on big configs.
        self._gt_cache: Dict = {}
        self._cache_lock = threading.Lock()

    def instance_bounds(self, inst: int) -> np.ndarray:
        """World AABB for one instance (tight when ``tight_bounds``)."""
        if not self.tight_bounds:
            return self.bounds
        r = self.base_radii[inst] * (1.0 + 0.18 * (self.num_layers - 1)) + 0.05
        c = self.centers[inst]
        return np.stack([c - r, c + r]).astype(np.float32)

    def __len__(self):
        return self.num_instances * self.num_layers * 64  # 64 virtual views

    def _density_color(self, inst: int, layer: int, pts: np.ndarray):
        dens = np.zeros(pts.shape[0], np.float32)
        color = np.zeros((pts.shape[0], 3), np.float32)
        for l in range(layer + 1):
            radii = self.base_radii[inst] * (1.0 + 0.18 * l)
            d = _ellipsoid_density(pts, self.centers[inst], radii).astype(np.float32)
            shell = np.clip(d - (dens > 0.5), 0, 1)
            color = np.where(
                (shell > 0.5)[:, None], self.colors[inst, l][None], color
            )
            dens = np.maximum(dens, d)
        return dens * 30.0, color

    def _camera(self, view: int):
        theta = 2 * np.pi * (view % 16) / 16
        phi = 0.3 * ((view // 16) % 4 - 1.5)
        eye = 3.0 * np.asarray(
            [np.cos(theta) * np.cos(phi), np.sin(phi), np.sin(theta) * np.cos(phi)]
        )
        fwd = -eye / np.linalg.norm(eye)
        up = np.asarray([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        R = np.stack([right, -up2, fwd], axis=0)  # world->cam
        T = (-R @ eye).reshape(3, 1)
        f = self.image_size * 1.2
        K = np.asarray(
            [[f, 0, self.image_size / 2], [0, f, self.image_size / 2], [0, 0, 1]]
        )
        return K, R, T

    def _quadrature(self, inst: int, layer: int, ro, rd, nr, fr,
                    n_samples: int | None = None):
        """Analytic GT (rgb, acc) along rays via dense uniform quadrature."""
        t = np.linspace(0, 1, n_samples or self.n_gt_samples, dtype=np.float32)
        z = nr[:, None] * (1 - t) + fr[:, None] * t
        pts = ro[:, None] + rd[:, None] * z[..., None]
        dens, color = self._density_color(inst, layer, pts.reshape(-1, 3))
        dens = dens.reshape(z.shape)
        color = color.reshape(*z.shape, 3)
        dists = np.diff(z, axis=-1, append=z[:, -1:] + 1e10)
        alpha = 1 - np.exp(-dens * dists)
        trans = np.cumprod(
            np.concatenate([np.ones_like(alpha[:, :1]), 1 - alpha + 1e-10], -1), -1
        )[:, :-1]
        w = alpha * trans
        rgb = (color * w[..., None]).sum(1).astype(np.float32)
        acc = w.sum(1).astype(np.float32)
        return rgb, acc

    def _view_gt(self, inst: int, layer: int, view: int) -> Dict[str, np.ndarray]:
        """Full-view GT for the in-box rays, cached per (inst, layer, view)."""
        key = (inst, layer, view)
        with self._cache_lock:
            cached = self._gt_cache.get(key)
        if cached is not None:
            return cached
        bounds = self.instance_bounds(inst)
        K, R, T = self._camera(view)
        S = self.image_size
        ray_o, ray_d = get_rays(S, S, K, R, T)
        ray_o = ray_o.reshape(-1, 3).astype(np.float32)
        ray_d = ray_d.reshape(-1, 3).astype(np.float32)
        near, far, hit = intersect_aabb(bounds, ray_o, ray_d)
        idx = np.where(hit)[0]
        ro, rd = ray_o[idx], ray_d[idx]
        nr = near[idx].astype(np.float32)
        fr = far[idx].astype(np.float32)
        rgb, acc = self._quadrature(inst, layer, ro, rd, nr, fr)
        cached = {
            "rays_o": ro, "rays_d": rd, "near": nr, "far": fr,
            "rgb": rgb, "acc": acc,
            "body_idx": np.where(acc > 0.5)[0],
            "bg_idx": np.where(acc <= 0.5)[0],
            "box_warp": bounds,
        }
        with self._cache_lock:
            self._gt_cache[key] = cached
        return cached

    def item(self, index: int, rng: np.random.Generator | None = None) -> Dict[str, np.ndarray]:
        rng = rng or np.random.default_rng(index)
        per_layer = 64
        per_inst = self.num_layers * per_layer
        inst = (index // per_inst) % self.num_instances
        layer = (index % per_inst) // per_layer
        view = index % per_layer

        gt = self._view_gt(inst, layer, view)
        # Body/bg-weighted selection at ratio 0.8 like the real loaders
        # (if_nerf_data_utils.py:115-160) — uniform box sampling is ~90% empty
        # rays here and invites the black-fog density collapse.
        body = gt["body_idx"]
        bg = gt["bg_idx"]
        if len(body) == 0:
            body = bg
        if len(bg) == 0:
            bg = body
        n_body = int(self.n_rays * 0.8)
        sel = np.concatenate(
            [
                body[rng.integers(0, len(body), n_body)],
                bg[rng.integers(0, len(bg), self.n_rays - n_body)],
            ]
        )
        acc = gt["acc"][sel]
        return {
            "instance_idx": np.int32(inst),
            "layer_idx": np.int32(layer),
            "rays_o": gt["rays_o"][sel],
            "rays_d": gt["rays_d"][sel],
            "near": gt["near"][sel],
            "far": gt["far"][sel],
            "rgb": gt["rgb"][sel],
            "bkgd_msk": (acc > 0.5).astype(np.float32),
            "ray_mask": np.ones(self.n_rays, np.float32),
            "box_warp": gt["box_warp"],
        }

    def _test_camera(self, view_id: int):
        """Held-out novel-view camera for reference view ids 145..185.

        Thetas/phis are offset half-steps from the 16x4 training grid, so no
        test view ever coincides with a training view (the analog of the
        reference's novel-view split, all_test.py:100-109)."""
        i = view_id - 145
        theta = 2 * np.pi * (i / 41.0) + np.pi / 16
        phi = 0.3 * ((i % 4) - 1.5) + 0.075
        eye = 3.0 * np.asarray(
            [np.cos(theta) * np.cos(phi), np.sin(phi), np.sin(theta) * np.cos(phi)]
        )
        fwd = -eye / np.linalg.norm(eye)
        up = np.asarray([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        R = np.stack([right, -up2, fwd], axis=0)
        T = (-R @ eye).reshape(3, 1)
        f = self.image_size * 1.2
        K = np.asarray(
            [[f, 0, self.image_size / 2], [0, f, self.image_size / 2], [0, 0, 1]]
        )
        return K, R, T

    def test_item(
        self, inst: int, layer: int, view_id: int, n_gt_samples: int = 192
    ) -> Dict[str, np.ndarray]:
        """Full-image held-out view item in the eval-harness schema.

        GT rgb comes from dense analytic quadrature (``n_gt_samples`` uniform
        samples — denser than training's 96 so the integration error sits well
        below the fit error) computed only on the in-mask rays.
        """
        bounds = self.instance_bounds(inst)
        K, R, T = self._test_camera(view_id)
        S = self.image_size
        ro, rd, near, far, mask = full_image_rays(S, S, K, R, T, bounds)
        ro = ro.reshape(-1, 3)
        rd = rd.reshape(-1, 3)
        near = near.reshape(-1)
        far = far.reshape(-1)
        mask = mask.reshape(-1).astype(bool)

        rgb = np.zeros((S * S, 3), np.float32)
        acc = np.zeros((S * S,), np.float32)
        idx = np.where(mask)[0]
        if idx.size:
            rgb[idx], acc[idx] = self._quadrature(
                inst, layer, ro[idx], rd[idx],
                near[idx].astype(np.float32), far[idx].astype(np.float32),
                n_samples=n_gt_samples,
            )

        return {
            "hw": np.asarray([S, S], np.int32),
            "acc": acc,
            "rays_o": ro.astype(np.float32),
            "rays_d": rd.astype(np.float32),
            "near": near.astype(np.float32),
            "far": far.astype(np.float32),
            "ray_mask": mask.astype(np.float32),
            "rgb": rgb,
            "box_warp": bounds,
        }
