"""TightCap dataset: canonical-space layered humans with on-the-fly layer
compositing (port of ``humanliff_tpu/data/tightcap.py``; reference
recon_NeRF/lib/TightCap_dataset.py).

Subjects are listed in ``TightCap_human_list.txt``; cameras in
``person-top-bottom-shoes/cameras.json`` (:51); SMPL (not SMPL-X) fits in
``person-top-bottom-shoes/outputs_re_fitting/refit_smpl_2nd.npz``; y-bound
padding 0.1 (:102-103). A layer's image is composed from the fully dressed
capture and the garment masks (:233-298): layer k erases the pixels of
garments not yet added and paints skin they hid in the constant colour
(0.607186, 0.49289057, 0.43795943).

An item is two steps: :meth:`TightCapDataset.read_view` reads the files
(``imageio`` and ``cv2``, imported when called, as in JAX) and
:func:`build_item` turns arrays into the item, so that images made in
memory give items without files. Items carry the SMPL arrays of the
inverse-LBS deform and ``box_warp`` = the big pose's bounds; near and far
come from the posed world bounds.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from humanliff_tpu_torch.bodymodel.bigpose import big_pose_params
from humanliff_tpu_torch.bodymodel.smpl import BodyModel, lbs_forward_np
from humanliff_tpu_torch.data.raygen import full_image_rays, sample_ray_batch_train

SKIN_COLOR = np.array([0.607186, 0.49289057, 0.43795943], np.float32)
FULL_DIR = "person-top-bottom-shoes"
GARMENT_DIRS = {"naked": "person", "top": "top", "bottom": "bottom", "shoes": "shoes"}


def composite_layer_image(layer: int, img: np.ndarray, full_mask: np.ndarray,
                          garment_masks: Dict[str, np.ndarray]):
    """The layer-k image and mask from the fully dressed capture and the
    garment masks (binary float; keys 'naked', 'top', 'bottom', 'shoes')."""
    img = img.copy()
    naked = garment_masks["naked"]
    if layer == 3:
        img[full_mask == 0] = 0
        return img, full_mask
    top, bottom, shoes = (garment_masks[k] for k in ("top", "bottom", "shoes"))
    absent = {0: [top, bottom, shoes], 1: [top, shoes], 2: [shoes]}[layer]
    for g in absent:
        img[(g == 1) & ((naked + g) == 1)] = 0
    img[naked + sum(absent) >= 2] = SKIN_COLOR
    img[full_mask == 0] = 0
    msk = np.zeros_like(full_mask)
    msk[img.sum(-1) != 0] = 1
    return img, msk


def _bounds_from_verts(verts: np.ndarray, pad: float = 0.05, y_extra: float = 0.1):
    mn = verts.min(0) - pad
    mx = verts.max(0) + pad
    mn[1] -= y_extra
    mx[1] += y_extra
    return np.stack([mn, mx], 0).astype(np.float32)


def big_pose_bounds(body_model: BodyModel):
    """(big pose (J*3,), its mean-shape vertices (V, 3), their bounds (2, 3))."""
    t_pose = big_pose_params(body_model.num_joints * 3)
    t_verts = lbs_forward_np(body_model, t_pose,
                             np.zeros(body_model.shapedirs.shape[-1], np.float32))
    return t_pose, t_verts, _bounds_from_verts(t_verts)


def build_item(body_model: BodyModel, layer: int, img: np.ndarray, full_mask: np.ndarray,
               garments: Dict[str, np.ndarray], K, R_cam, T_cam, poses, betas, Rg, Th,
               t_pose, t_world_bounds, instance: int = 0, split: str = "train",
               n_rays: int = 2048, image_scaling: float = 1.0,
               rng: np.random.Generator | None = None) -> Dict[str, np.ndarray]:
    """One item from arrays: the capture ``img`` (H, W, 3) in [0, 1], its
    ``full_mask`` and garment masks (H, W), the camera (K, R_cam, T_cam), the
    SMPL fit (poses (J*3,), betas, the global Rg (3, 3) and Th (3,)) and the
    big pose and its bounds. Train items carry ``n_rays`` rays drawn with
    ``rng``; test items every pixel's ray and ``hw``."""
    img, msk = composite_layer_image(layer, img, full_mask, garments)
    K = np.asarray(K, np.float64).copy()
    H, W = img.shape[:2]
    H2, W2 = int(H * image_scaling), int(W * image_scaling)
    if (H2, W2) != (H, W):
        import cv2

        img = cv2.resize(img, (W2, H2), interpolation=cv2.INTER_AREA)
        msk = cv2.resize(msk, (W2, H2), interpolation=cv2.INTER_NEAREST)
        K[:2] = K[:2] * image_scaling

    verts_smpl = lbs_forward_np(body_model, poses, betas)  # SMPL space
    world_bounds = _bounds_from_verts(verts_smpl @ Rg.T + Th)
    base = {"instance_idx": np.int32(instance), "layer_idx": np.int32(layer),
            "box_warp": t_world_bounds, "poses": poses, "betas": betas,
            "smpl_verts": verts_smpl, "R": Rg, "Th": Th, "t_poses": t_pose}
    if split == "train":
        rays = sample_ray_batch_train(img, msk, K, R_cam, T_cam, world_bounds, n_rays,
                                      rng=rng or np.random.default_rng())
        base.update(rays_o=rays["ray_o"], rays_d=rays["ray_d"], near=rays["near"],
                    far=rays["far"], rgb=rays["rgb"], bkgd_msk=rays["bkgd"],
                    ray_mask=rays["ray_mask"])
    else:
        ray_o, ray_d, near, far, mask = full_image_rays(H2, W2, K, R_cam, T_cam, world_bounds)
        base.update(rays_o=ray_o, rays_d=ray_d, near=near, far=far,
                    rgb=img.reshape(-1, 3).astype(np.float32),
                    bkgd_msk=msk.reshape(-1).astype(np.float32),
                    ray_mask=mask.astype(np.float32), hw=np.asarray([H2, W2], np.int32))
    return base


@dataclass
class TightCapDataset:
    data_root: str
    body_model: BodyModel
    num_instances: int = 1
    pose_start: int = 0
    pose_interval: int = 1
    poses_num: int = 1
    views_num: int = 382
    n_rays: int = 2048
    image_scaling: float = 1.0
    layer_idx: Optional[int] = None
    split: str = "train"

    def __post_init__(self):
        all_root = os.path.dirname(self.data_root)
        with open(os.path.join(all_root, "TightCap_human_list.txt")) as f:
            dirs = [x.strip() for x in f.readlines()[: self.num_instances]]
        self.subject_roots = [os.path.join(all_root, d) for d in dirs]
        self.cams = []
        for r in self.subject_roots:
            with open(os.path.join(r, FULL_DIR, "cameras.json")) as f:
                self.cams.append(json.load(f))
        self.num_layers = 4 if self.layer_idx is None else 1
        self.t_pose, self.t_vertices, self.t_world_bounds = big_pose_bounds(self.body_model)
        self._smpl_cache: Dict[str, dict] = {}

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

    def _smpl_params(self, subject: int, pose_index: int):
        root = self.subject_roots[subject]
        if root not in self._smpl_cache:
            path = os.path.join(root, FULL_DIR, "outputs_re_fitting", "refit_smpl_2nd.npz")
            self._smpl_cache[root] = dict(np.load(path, allow_pickle=True))["smpl"].item()
        p = self._smpl_cache[root]
        poses = np.zeros(self.body_model.num_joints * 3, np.float32)
        poses[:3] = np.asarray(p["global_orient"][pose_index], np.float32).reshape(-1)
        poses[3:] = np.asarray(p["body_pose"][pose_index], np.float32).reshape(-1)
        betas = np.asarray(p["betas"], np.float32).reshape(-1)
        Th = np.asarray(p["transl"][0], np.float32).reshape(3)
        return poses, betas, np.eye(3, dtype=np.float32), Th

    def read_view(self, index: int) -> dict:
        """The files of item ``index``: the capture, its masks and camera and
        the SMPL fit, as :func:`build_item`'s arguments."""
        import imageio.v2 as imageio

        s, layer, pose_idx, view = self._decompose(index)
        root = self.subject_roots[s]
        cam = self.cams[s][f"camera{view:04d}"]

        def read_mask(d):
            m = np.asarray(imageio.imread(
                os.path.join(root, d, "mask", f"camera{view:04d}", f"{pose_idx:04d}.png")))
            m = (m != 0).astype(np.float32)
            return m[..., 0] if m.ndim == 3 else m

        img = np.asarray(imageio.imread(os.path.join(
            root, FULL_DIR, "img", f"camera{view:04d}", f"{pose_idx:04d}.jpg")),
            np.float32) / 255.0
        poses, betas, Rg, Th = self._smpl_params(s, pose_idx)
        return dict(layer=layer, img=img, full_mask=read_mask(FULL_DIR),
                    garments={k: read_mask(d) for k, d in GARMENT_DIRS.items()},
                    K=cam["K"], R_cam=np.asarray(cam["R"], np.float64),
                    T_cam=np.asarray(cam["T"], np.float64).reshape(3, 1),
                    poses=poses, betas=betas, Rg=Rg, Th=Th, instance=s)

    def item(self, index: int, rng: np.random.Generator | None = None) -> Dict[str, np.ndarray]:
        return build_item(self.body_model, **self.read_view(index), t_pose=self.t_pose,
                          t_world_bounds=self.t_world_bounds, split=self.split,
                          n_rays=self.n_rays, image_scaling=self.image_scaling, rng=rng)

    def test_item(self, subject: int, layer: int, view: int) -> Dict[str, np.ndarray]:
        """The full-image item of (subject, layer, view) at the first pose,
        the JAX recon_test's ``item(subject * 4 * per_layer + layer *
        per_layer + view)`` with split 'test'."""
        per_layer = self.poses_num * self.views_num
        return build_item(self.body_model, **self.read_view(
            subject * 4 * per_layer + layer * per_layer + view), t_pose=self.t_pose,
            t_world_bounds=self.t_world_bounds, split="test", image_scaling=self.image_scaling)
