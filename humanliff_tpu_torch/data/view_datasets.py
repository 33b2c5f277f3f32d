"""Novel-view sets for decoding generated tri-planes (port of
``humanliff_tpu/data/view_datasets.py``; reference
human_diffusion/SynBodyView_datasets.py, TightCapView_datasets.py).

:class:`NovelViewCameras`: cameras from a capture's ``cameras.json`` (views
145-184 by default, the reference's novel views, SynBodyView_datasets.py:20)
or, without one, a procedural orbit of 40 cameras. One divergence: the JAX
class silently falls back to the orbit when ``cameras_json`` names a missing
file; this one raises.

:class:`SynBodyViewDataset` and :class:`TightCapViewDataset` compose the
Stage-1 datasets' test split: full-image rays against the subject's posed
world bounds, the SMPL arrays (TightCap renders in canonical space), and the
ground-truth plane pair (x, x_cond) read lazily from a packed Stage-2 array.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
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


class _PackedPlanes:
    """Lazy ground-truth plane access: ``packed_path`` is the packed Stage-2
    array (``data/triplane_data.py``), memory-mapped."""

    def __init__(self, packed_path: Optional[str]):
        self.planes = None
        if packed_path:
            self.planes = np.load(packed_path, mmap_mode="r")  # (N, L, C, D, D)
            if self.planes.ndim != 5:
                raise ValueError(f"packed planes must be (N, L, C, D, D), got "
                                 f"{self.planes.shape}")

    def pair(self, subject: int, layer: int):
        """(x, x_cond) as (C, D, D) fp32, x_cond zeros for layer 0
        (SynBodyView_datasets.py:283-287); (None, None) without planes."""
        if self.planes is None:
            return None, None
        x = np.asarray(self.planes[subject, layer], np.float32)
        cond = (np.zeros_like(x) if layer == 0
                else np.asarray(self.planes[subject, layer - 1], np.float32))
        return x, cond


class _ViewDatasetBase:
    """Items over (subject, pose, view) from a Stage-1 dataset's test split
    (``self._base``) with the plane pair attached (``self._planes``)."""

    def __len__(self) -> int:
        return self.num_instances * self.pose_num * len(self.output_views)

    def _decompose(self, index: int):
        nv = len(self.output_views)
        s = index // (self.pose_num * nv)
        pose_slot = (index // nv) % self.pose_num
        layer = 0 if self.layer_idx is None else int(self.layer_idx)
        return s, layer, pose_slot, self.output_views[index % nv]

    def item(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        s, layer, pose_slot, view = self._decompose(index)
        b = self._base
        out = b.item(((s * b.num_layers + layer) * b.poses_num + pose_slot) * b.views_num + view)
        x, x_cond = self._planes.pair(s, layer)
        if x is not None:
            out["x"] = x
            out["x_cond"] = x_cond
        out["y"] = np.int32(layer)
        out["view_index"] = np.int32(view)
        out["t_world_bounds"] = self.t_world_bounds
        return out


@dataclass
class SynBodyViewDataset(_ViewDatasetBase):
    """Novel-view items for decoding generated SynBody planes, in world space
    (SynBodyView_datasets.py:215-308): ``box_warp`` is the posed bounds."""

    data_root: str
    body_models: Dict  # gender -> BodyModel
    triplane_packed: Optional[str] = None
    num_instances: int = 1
    pose_start: int = 0
    pose_interval: int = 5
    pose_num: int = 1
    image_scaling: float = 0.5
    layer_idx: Optional[int] = None
    output_views: List[int] = field(default_factory=lambda: list(DEFAULT_NOVEL_VIEWS))

    def __post_init__(self):
        from humanliff_tpu_torch.data.synbody import SynBodyDataset

        self._base = SynBodyDataset(
            data_root=self.data_root, body_models=self.body_models,
            num_instances=self.num_instances, pose_start=self.pose_start,
            pose_interval=self.pose_interval, poses_num=self.pose_num,
            views_num=max(self.output_views) + 1, image_scaling=self.image_scaling,
            layer_idx=None, split="test")
        self._planes = _PackedPlanes(self.triplane_packed)
        self.t_world_bounds = self._base.t_world_bounds
        self.t_vertices = self._base.t_vertices


@dataclass
class TightCapViewDataset(_ViewDatasetBase):
    """Novel-view items for decoding generated TightCap planes, in canonical
    space (TightCapView_datasets.py:34-37, :208-360): the SMPL arrays of the
    deform, ``box_warp`` the big pose's bounds, near and far from the posed
    bounds."""

    data_root: str
    body_model: object  # SMPL BodyModel
    triplane_packed: Optional[str] = None
    num_instances: int = 1
    pose_start: int = 0
    pose_interval: int = 5
    pose_num: int = 1
    image_scaling: float = 1.0
    layer_idx: Optional[int] = None
    output_views: List[int] = field(default_factory=lambda: list(DEFAULT_NOVEL_VIEWS))

    def __post_init__(self):
        from humanliff_tpu_torch.data.tightcap import TightCapDataset

        self._base = TightCapDataset(
            data_root=self.data_root, body_model=self.body_model,
            num_instances=self.num_instances, pose_start=self.pose_start,
            pose_interval=self.pose_interval, poses_num=self.pose_num,
            views_num=max(self.output_views) + 1, image_scaling=self.image_scaling,
            layer_idx=None, split="test")
        self._planes = _PackedPlanes(self.triplane_packed)
        self.t_world_bounds = self._base.t_world_bounds
        self.t_vertices = self._base.t_vertices
