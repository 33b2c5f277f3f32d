"""Linear-blend-skinning body model covering SMPL and SMPL-X (port of
``humanliff_tpu/bodymodel/smpl.py``; reference recon_NeRF/smpl/smpl_numpy.py:46-97,
smplx/body_models.py, lib/renderer.py:373-401).

A :class:`BodyModel` holds numpy arrays; :meth:`BodyModel.tensors` moves them
to a device once and keeps them there. The functions take torch tensors of
poses and shapes and run on their device. SMPL has J 24 joints and V 6,890
vertices, SMPL-X J 55 and V 10,475 with expression blendshapes: different
array shapes of the same model.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from humanliff_tpu_torch.bodymodel.kinematics import rigid_transform_chain
from humanliff_tpu_torch.bodymodel.rotations import batch_rodrigues

_ARRAYS = ("v_template", "shapedirs", "posedirs", "J_regressor", "weights", "expr_dirs")


@dataclasses.dataclass(frozen=True, eq=False)
class BodyModel:
    """Body-model arrays (host numpy).

    v_template (V, 3); shapedirs (V, 3, n_betas); posedirs (V*3, (J-1)*9), the
    reference layout (renderer.py:90); J_regressor (J, V); weights (V, J);
    parents (J,); optional expr_dirs (V, 3, n_expr) (SMPL-X) and faces (F, 3).
    """

    v_template: np.ndarray
    shapedirs: np.ndarray
    posedirs: np.ndarray
    J_regressor: np.ndarray
    weights: np.ndarray
    parents: np.ndarray
    expr_dirs: Optional[np.ndarray] = None
    faces: Optional[np.ndarray] = None
    _on_device: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def num_joints(self) -> int:
        return int(self.parents.shape[0])

    @property
    def num_verts(self) -> int:
        return int(self.v_template.shape[0])

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """The model's float arrays as fp32 tensors on ``device``, made once."""
        key = str(torch.device(device))
        got = self._on_device.get(key)
        if got is None:
            got = {name: torch.from_numpy(np.asarray(getattr(self, name), np.float32)).to(device)
                   for name in _ARRAYS if getattr(self, name) is not None}
            self._on_device[key] = got
        return got


def _shaped_template(model: BodyModel, betas: torch.Tensor,
                     expression: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shape (and expression) blendshapes applied: (B, V, 3). The banks are
    sliced to the caller's coefficient count (smplx ships 300 shape dirs,
    models use 10)."""
    t = model.tensors(betas.device)
    v = t["v_template"][None] + torch.einsum(
        "vdn,bn->bvd", t["shapedirs"][..., :betas.shape[-1]], betas)
    if expression is not None and "expr_dirs" in t:
        v = v + torch.einsum("vdn,bn->bvd", t["expr_dirs"][..., :expression.shape[-1]],
                             expression)
    return v


def _pose_offsets(model: BodyModel, rot_mats: torch.Tensor) -> torch.Tensor:
    """Pose-dependent corrective offsets (B, V, 3) (renderer.py:86-92)."""
    B = rot_mats.shape[0]
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)  # (B, (J-1)*9)
    return (pose_feature @ model.tensors(rot_mats.device)["posedirs"].T).reshape(B, -1, 3)


def transform_params(model: BodyModel, poses: torch.Tensor, betas: torch.Tensor,
                     expression: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-joint skinning transforms A (B, J, 4, 4) and rest joints (B, J, 3)
    of poses (B, J*3) and betas (B, n) (``get_transform_params_torch``,
    renderer.py:373-401, without the global R and Th)."""
    B = poses.shape[0]
    v_shaped = _shaped_template(model, betas, expression)
    rot_mats = batch_rodrigues(poses.reshape(B, -1, 3))
    joints = torch.einsum("jv,bvd->bjd", model.tensors(poses.device)["J_regressor"], v_shaped)
    return rigid_transform_chain(rot_mats, joints, model.parents), joints


def lbs_forward(model: BodyModel, poses: torch.Tensor, betas: torch.Tensor,
                expression: Optional[torch.Tensor] = None,
                global_rot: Optional[torch.Tensor] = None,
                global_trans: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posed vertices (B, V, 3) and joints (B, J, 3) (smpl_numpy.py:46-97,
    smplx lbs.py:156); ``global_rot`` (B, 3, 3) and ``global_trans`` (B, 3)
    apply as ``v @ R^T + t`` after skinning."""
    B = poses.shape[0]
    t = model.tensors(poses.device)
    v_shaped = _shaped_template(model, betas, expression)
    rot_mats = batch_rodrigues(poses.reshape(B, -1, 3))
    joints = torch.einsum("jv,bvd->bjd", t["J_regressor"], v_shaped)
    A = rigid_transform_chain(rot_mats, joints, model.parents)
    v_posed = v_shaped + _pose_offsets(model, rot_mats)
    T = torch.einsum("vj,bjxy->bvxy", t["weights"], A)  # (B, V, 4, 4)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = (T @ v_h[..., None])[..., :3, 0]
    posed_joints = torch.einsum("jv,bvd->bjd", t["J_regressor"], verts)
    if global_rot is not None:
        verts = torch.einsum("bij,bvj->bvi", global_rot, verts)
        posed_joints = torch.einsum("bij,bvj->bvi", global_rot, posed_joints)
    if global_trans is not None:
        verts = verts + global_trans[:, None]
        posed_joints = posed_joints + global_trans[:, None]
    return verts, posed_joints


def lbs_forward_np(model: BodyModel, poses, betas, expression=None, global_trans=None
                   ) -> np.ndarray:
    """:func:`lbs_forward` of one item's numpy arrays on the CPU: posed
    vertices (V, 3) as fp32 numpy (the loaders' use)."""
    def batch(a):
        return None if a is None else torch.from_numpy(np.asarray(a, np.float32))[None]

    with torch.no_grad():
        verts, _ = lbs_forward(model, batch(poses), batch(betas), expression=batch(expression),
                               global_trans=batch(global_trans))
    return verts[0].numpy()


def make_synthetic_body_model(J: int = 4, V: int = 64, n_betas: int = 5,
                              seed: int = 0) -> BodyModel:
    """A random kinematic-chain body model from a seed, no assets (the JAX
    package's, array for array). At J 24, V 6,890, n_betas 10 it has SMPL's
    array shapes."""
    rng = np.random.default_rng(seed)
    parents = np.arange(-1, J - 1)
    parents[0] = 0  # the root points at itself, like SMPL's kintree[0]
    joints = np.cumsum(rng.uniform(0.1, 0.3, size=(J, 3)), axis=0).astype(np.float32)
    verts = (joints[rng.integers(0, J, size=V)]
             + rng.normal(scale=0.05, size=(V, 3))).astype(np.float32)

    # Nearest-vertex one-hot regressor, then the joints re-derived so it is exact.
    Jreg = np.zeros((J, V), np.float32)
    for j in range(J):
        Jreg[j, np.argmin(np.linalg.norm(verts - joints[j], axis=1))] = 1.0
    d = np.linalg.norm(verts[:, None] - (Jreg @ verts)[None], axis=-1)
    w = np.exp(-d / 0.05)
    weights = (w / w.sum(1, keepdims=True)).astype(np.float32)

    shapedirs = rng.normal(scale=0.01, size=(V, 3, n_betas)).astype(np.float32)
    posedirs = rng.normal(scale=0.001, size=(V * 3, (J - 1) * 9)).astype(np.float32)
    return BodyModel(v_template=verts, shapedirs=shapedirs, posedirs=posedirs,
                     J_regressor=Jreg, weights=weights, parents=parents)


def find_smplx_model(model_dir: str, gender: str) -> str:
    """``SMPLX_{GENDER}`` under ``model_dir``: the ``.npz`` distribution first,
    then the pkl."""
    for ext in (".npz", ".pkl"):
        cand = os.path.join(model_dir, f"SMPLX_{gender.upper()}{ext}")
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"no SMPLX_{gender.upper()}.npz/.pkl under {model_dir}")


_MODEL_CACHE: Dict[str, BodyModel] = {}


def load_body_model(path: str) -> BodyModel:
    """A SMPL/SMPL-X model file as a :class:`BodyModel`: the SMPL pickle
    (latin1, renderer.py:352-371) or the smplx ``.npz`` distribution
    (SynBody_dataset.py:85-99). A sparse ``J_regressor`` is densified; a
    SMPL-X ``shapedirs`` of more than 300 columns splits into 300 shape and
    10 expression directions. Cached per absolute path."""
    cache_key = os.path.abspath(path)
    cached = _MODEL_CACHE.get(cache_key)
    if cached is not None:
        return cached
    if path.endswith(".npz"):
        data = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            u = pickle._Unpickler(f)
            u.encoding = "latin1"
            data = u.load()

    J_reg = data["J_regressor"]
    if hasattr(J_reg, "toarray"):
        J_reg = J_reg.toarray()
    shapedirs = np.asarray(data["shapedirs"], np.float32)
    posedirs = np.asarray(data["posedirs"], np.float32)
    if posedirs.ndim == 3:  # (V, 3, (J-1)*9) -> the reference layout (V*3, (J-1)*9)
        posedirs = posedirs.reshape(-1, posedirs.shape[-1])
    expr_dirs = None
    if shapedirs.shape[-1] > 300:  # smplx: betas | expressions
        expr_dirs = shapedirs[..., 300:310]
        shapedirs = shapedirs[..., :300]
    model = BodyModel(
        v_template=np.asarray(data["v_template"], np.float32),
        shapedirs=shapedirs,
        posedirs=posedirs,
        J_regressor=np.asarray(J_reg, np.float32),
        weights=np.asarray(data["weights"], np.float32),
        parents=np.asarray(data["kintree_table"])[0].astype(np.int32),
        expr_dirs=expr_dirs,
        faces=np.asarray(data["f"], np.int32) if "f" in data else None,
    )
    _MODEL_CACHE[cache_key] = model
    return model
