"""Novel-view cameras for decoding generated tri-planes (port of
``humanliff_tpu/data/view_datasets.py::NovelViewCameras``).

The cameras come from a capture's ``cameras.json`` (views 145-184 by default,
the reference's novel views, SynBodyView_datasets.py:20) or, without one, from
a procedural orbit of 40 cameras. One divergence: the JAX class silently falls
back to the orbit when ``cameras_json`` names a missing file; this one raises.
The SynBody and TightCap view sets are not ported yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from humanliff_tpu_torch.data.raygen import full_image_rays

DEFAULT_NOVEL_VIEWS: List[int] = list(range(145, 185))  # 40 views


@dataclass
class NovelViewCameras:
    """``len(views)`` cameras: a capture's, or an orbit at distance 3 around the origin."""

    image_size: int = 512
    cameras_json: Optional[str] = None
    views: Optional[List[int]] = None
    image_scaling: float = 1.0

    def __post_init__(self):
        self.views = self.views or DEFAULT_NOVEL_VIEWS
        self._cams = None
        if self.cameras_json:
            with open(self.cameras_json) as f:
                self._cams = json.load(f)

    def __len__(self):
        return len(self.views)

    def camera(self, i: int):
        """Returns (K, R, T) for novel view i."""
        view = self.views[i]
        if self._cams is not None:
            cam = self._cams[f"camera{view:04d}"]
            K = np.asarray(cam["K"], np.float64).copy()
            K[:2] *= self.image_scaling
            return (K, np.asarray(cam["R"], np.float64),
                    np.asarray(cam["T"], np.float64).reshape(3, 1))
        S = self.image_size
        theta = 2 * np.pi * i / max(len(self.views), 1)
        eye = np.asarray([np.cos(theta), 0.15, np.sin(theta)])
        eye = 3.0 * eye / np.linalg.norm(eye)
        fwd = -eye / np.linalg.norm(eye)
        up = np.asarray([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        R = np.stack([right, -up2, fwd], axis=0)
        T = (-R @ eye).reshape(3, 1)
        f = S * 1.1
        K = np.asarray([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]])
        return K, R, T

    def rays(self, i: int, bounds: np.ndarray) -> Dict[str, np.ndarray]:
        """View i's full-image rays against ``bounds``, as host numpy arrays."""
        K, R, T = self.camera(i)
        S = self.image_size
        ray_o, ray_d, near, far, mask = full_image_rays(S, S, K, R, T, bounds)
        return {"rays_o": ray_o, "rays_d": ray_d, "near": near, "far": far,
                "ray_mask": mask.astype(np.float32), "hw": np.asarray([S, S], np.int32)}
