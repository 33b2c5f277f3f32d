"""Procedural orbit cameras for decoding generated tri-planes.

Port of the orbit branch of ``humanliff_tpu/data/view_datasets.py::NovelViewCameras``
(the ``cameras_json`` branch, which reads a capture's cameras, and the per-view
ray dict are not ported yet; rays come from ``data.raygen.full_image_rays``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

DEFAULT_NOVEL_VIEWS: List[int] = list(range(145, 185))  # 40 views


@dataclass
class NovelViewCameras:
    """An orbit of ``len(views)`` cameras at distance 3 around the origin."""

    image_size: int = 512
    views: Optional[List[int]] = None

    def __post_init__(self):
        self.views = self.views or DEFAULT_NOVEL_VIEWS

    def __len__(self):
        return len(self.views)

    def camera(self, i: int):
        """Returns (K, R, T) for novel view i."""
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
