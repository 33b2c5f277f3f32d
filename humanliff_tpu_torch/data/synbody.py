"""SynBody dataset: multi-view layered-human images and SMPL-X fits (port of
``humanliff_tpu/data/synbody.py``; reference recon_NeRF/lib/SynBody_dataset.py).

Layout ``{root}/{subject}/{layer_dir}/{img,mask}/camera{v:04d}/{pose:04d}.{jpg,png}``
with ``cameras.json`` and ``smplx.npz``; layer directories ``person``,
``person-pants``, ``person-pants-shirt``, ``person-pants-shirt-shoes``
(:253-264). Images scale by ``image_scaling`` (0.5) with K rescaled
(:274-279). SynBody trains in world space: ``box_warp`` is the posed
SMPL-X vertices' bounds.

As in ``data/tightcap.py``, :meth:`SynBodyDataset.read_view` reads the files
and :func:`build_item` makes the item from arrays.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from humanliff_tpu_torch.bodymodel.smpl import BodyModel, lbs_forward_np
from humanliff_tpu_torch.data.raygen import full_image_rays, sample_ray_batch_train

LAYER_DIRS = ["person", "person-pants", "person-pants-shirt", "person-pants-shirt-shoes"]

SMPLX_POSE_KEYS = [  # concatenation order of the 165-d full pose (55 joints)
    "global_orient", "body_pose", "jaw_pose", "leye_pose", "reye_pose",
    "left_hand_pose", "right_hand_pose",
]


def smplx_big_pose(num_joints: int = 55) -> np.ndarray:
    """The big pose as a full-pose vector: body_pose[2, 5, 20, 23] set
    (SynBody_dataset.py:221-224), i.e. full-pose indices shifted by the 3
    global-orient dims."""
    pose = np.zeros(num_joints * 3, np.float32)
    for idx, deg in ((3 + 2, 45.0), (3 + 5, -45.0), (3 + 20, -30.0), (3 + 23, 30.0)):
        if idx < pose.shape[0]:  # toy models with few joints skip arm entries
            pose[idx] = np.deg2rad(deg)
    return pose


def _bounds_from_verts(verts: np.ndarray, pad: float = 0.05, y_extra: float = 0.05):
    mn = verts.min(0) - pad
    mx = verts.max(0) + pad
    mn[1] -= y_extra
    mx[1] += y_extra
    return np.stack([mn, mx], 0).astype(np.float32)


def _expression(model: BodyModel, expr):
    return expr if model.expr_dirs is not None else None


def build_item(model: BodyModel, layer: int, img: np.ndarray, msk: np.ndarray, K, R, T,
               full_pose, betas, expr, transl, instance: int = 0, split: str = "train",
               n_rays: int = 2048, image_scaling: float = 0.5,
               rng: np.random.Generator | None = None) -> Dict[str, np.ndarray]:
    """One item from arrays: the layer's image (H, W, 3) in [0, 1] and mask
    (H, W), the camera (K, R, T), and the SMPL-X fit posed by ``model``
    (full_pose (J*3,), betas, expression, transl (3,))."""
    img = img.copy()
    img[msk == 0] = 0
    K = np.asarray(K, np.float64).copy()
    H, W = img.shape[:2]
    H2, W2 = int(H * image_scaling), int(W * image_scaling)
    if (H2, W2) != (H, W):
        import cv2

        img = cv2.resize(img, (W2, H2), interpolation=cv2.INTER_AREA)
        msk = cv2.resize(msk, (W2, H2), interpolation=cv2.INTER_NEAREST)
        K[:2] = K[:2] * image_scaling

    verts = lbs_forward_np(model, full_pose, betas, expression=_expression(model, expr),
                           global_trans=transl)
    world_bounds = _bounds_from_verts(verts)
    out = {"instance_idx": np.int32(instance), "layer_idx": np.int32(layer)}
    if split == "train":
        rays = sample_ray_batch_train(img, msk, K, R, T, world_bounds, n_rays,
                                      rng=rng or np.random.default_rng())
        out.update(rays_o=rays["ray_o"], rays_d=rays["ray_d"], near=rays["near"],
                   far=rays["far"], rgb=rays["rgb"], bkgd_msk=rays["bkgd"],
                   ray_mask=rays["ray_mask"], box_warp=world_bounds)
    else:
        ray_o, ray_d, near, far, mask = full_image_rays(H2, W2, K, R, T, world_bounds)
        out.update(rays_o=ray_o, rays_d=ray_d, near=near, far=far,
                   rgb=img.reshape(-1, 3).astype(np.float32),
                   bkgd_msk=msk.reshape(-1).astype(np.float32),
                   ray_mask=mask.astype(np.float32), box_warp=world_bounds,
                   hw=np.asarray([H2, W2], np.int32))
    return out


@dataclass
class SynBodyDataset:
    data_root: str
    body_models: Dict[str, BodyModel]  # by gender: 'male', 'female', 'neutral'
    num_instances: int = 1
    pose_start: int = 0
    pose_interval: int = 1
    poses_num: int = 1
    views_num: int = 185
    n_rays: int = 2048
    image_scaling: float = 0.5
    layer_idx: Optional[int] = None
    split: str = "train"

    def __post_init__(self):
        all_root = os.path.dirname(self.data_root)
        with open(os.path.join(all_root, "human_list.txt")) as f:
            dirs = [x.strip() for x in f.readlines()[: self.num_instances]]
        self.subject_roots: List[str] = [os.path.join(all_root, d) for d in dirs]
        self.cams = []
        for r in self.subject_roots:
            with open(os.path.join(r, "cameras.json")) as f:
                self.cams.append(json.load(f))
        self.num_layers = 4 if self.layer_idx is None else 1
        # The canonical big pose's vertices and bounds, of the neutral model.
        model = self.body_models["neutral"]
        self.t_pose = smplx_big_pose(model.num_joints)
        self.t_vertices = lbs_forward_np(
            model, self.t_pose, np.zeros(model.shapedirs.shape[-1], np.float32),
            expression=_expression(model, np.zeros(10, np.float32)))
        self.t_world_bounds = _bounds_from_verts(self.t_vertices)
        self._smplx_cache: Dict[str, dict] = {}

    def __len__(self) -> int:
        return self.num_instances * self.num_layers * self.poses_num * self.views_num

    def _decompose(self, index: int):
        nv = self.views_num
        per_layer = self.poses_num * nv
        s = index // (self.num_layers * per_layer)
        rem = index - s * self.num_layers * per_layer
        layer = rem // per_layer
        rem -= layer * per_layer
        pose = (rem // nv) * self.pose_interval + self.pose_start
        if self.layer_idx is not None:
            layer = self.layer_idx
        return s, layer, pose, index % nv

    def _smplx_params(self, subject: int, pose_index: int):
        root = self.subject_roots[subject]
        if root not in self._smplx_cache:
            z = dict(np.load(os.path.join(root, "smplx.npz"), allow_pickle=True))
            self._smplx_cache[root] = {"params": z["smplx"].item(),
                                       "gender": z["meta"].item()["gender"]}
        entry = self._smplx_cache[root]
        p = entry["params"]
        full_pose = np.concatenate([np.asarray(p[k][pose_index], np.float32).reshape(-1)
                                    for k in SMPLX_POSE_KEYS])
        betas = np.asarray(p["betas"], np.float32).reshape(-1)
        expr = np.asarray(p["expression"][pose_index], np.float32).reshape(-1)
        transl = np.asarray(p["transl"][pose_index], np.float32).reshape(-1)
        return full_pose, betas, expr, transl, entry["gender"]

    def read_view(self, index: int) -> dict:
        """The files of item ``index`` as :func:`build_item`'s arguments."""
        import imageio.v2 as imageio

        s, layer, pose_idx, view = self._decompose(index)
        root = self.subject_roots[s]
        cam = self.cams[s][f"camera{view:04d}"]
        ld = LAYER_DIRS[layer]
        img = np.asarray(imageio.imread(os.path.join(
            root, ld, "img", f"camera{view:04d}", f"{pose_idx:04d}.jpg")), np.float32) / 255.0
        msk = np.asarray(imageio.imread(os.path.join(
            root, ld, "mask", f"camera{view:04d}", f"{pose_idx:04d}.png")))
        msk = (msk != 0).astype(np.float32)
        if msk.ndim == 3:
            msk = msk[..., 0]
        full_pose, betas, expr, transl, gender = self._smplx_params(s, pose_idx)
        return dict(model=self.body_models[gender], layer=layer, img=img, msk=msk,
                    K=cam["K"], R=np.asarray(cam["R"], np.float64),
                    T=np.asarray(cam["T"], np.float64).reshape(3, 1), full_pose=full_pose,
                    betas=betas, expr=expr, transl=transl, instance=s)

    def item(self, index: int, rng: np.random.Generator | None = None) -> Dict[str, np.ndarray]:
        return build_item(**self.read_view(index), split=self.split, n_rays=self.n_rays,
                          image_scaling=self.image_scaling, rng=rng)

    def test_item(self, subject: int, layer: int, view: int) -> Dict[str, np.ndarray]:
        """The full-image item of (subject, layer, view) at the first pose (the
        JAX recon_test's index arithmetic, split 'test')."""
        per_layer = self.poses_num * self.views_num
        return build_item(**self.read_view(subject * 4 * per_layer + layer * per_layer + view),
                          split="test", image_scaling=self.image_scaling)
