"""Point canonicalisation: observation-space samples into the shared big pose by
inverse linear-blend skinning (port of ``humanliff_tpu/bodymodel/canonical.py``;
reference ``deform_target2c_op``, recon_NeRF/lib/renderer.py:60-122, which used
pytorch3d's ``knn_points``).

Each point takes the skinning weights and blendshape offsets of its nearest
posed vertex, is un-skinned to the rest pose, loses the observed pose's and
shape's offsets, gains the big pose's and is skinned into the big pose. The
1-NN is ``argmin_v |v|^2 - 2 q.v`` (``|q|^2`` does not change the argmin),
a product and an ``argmin`` in plain PyTorch, as the JAX package computes it
outside any kernel. Each function keeps the JAX function's arithmetic:

- :func:`deform_to_canonical` (one item): the fp32 1-NN and an LU inverse of
  the blended rotation;
- :func:`deform_to_canonical_batched`: queries and vertices rounded to bf16,
  their products summed in fp32 and ``|v|^2`` from the unrounded vertices (an
  fp32 product of bf16-exact operands, ``torch.baddbmm``; a product whose
  output is rounded to bf16 picks other vertices for a quarter of the points),
  and the closed-form adjugate inverse. Neither slices ``shapedirs`` to the
  betas' count, as in JAX.

The deform runs without autograd (JAX differentiates nothing through it: the
planes get gradients, not the points), and the batched 1-NN runs ``tile``
points per item at a time, so the (B, M, V) distance block never exists
whole (about 1.8 GB per item at 2^16 points and SMPL's 6,890 vertices).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from humanliff_tpu_torch.bodymodel.rotations import batch_rodrigues
from humanliff_tpu_torch.bodymodel.smpl import BodyModel, _pose_offsets, transform_params

NN_TILE = 1 << 16  # query points per item in one block of the batched 1-NN


@torch.no_grad()
def nearest_vertex_batched(query: torch.Tensor, verts: torch.Tensor,
                           tile: int = NN_TILE) -> torch.Tensor:
    """Index (B, M) int64 of the nearest of ``verts`` (B, V, 3) to each point
    of ``query`` (B, M, 3), from bf16-rounded operands with fp32 products
    (JAX ``deform_to_canonical_batched``'s 1-NN); the first of equal
    minima."""
    v16 = verts.to(torch.bfloat16).float().mT.contiguous()  # (B, 3, V)
    v_sq = (verts * verts).sum(-1)[:, None, :]  # (B, 1, V), unrounded fp32
    out = torch.empty(query.shape[:2], dtype=torch.long, device=query.device)
    for s in range(0, query.shape[1], tile):
        q16 = query[:, s:s + tile].to(torch.bfloat16).float()
        d = torch.baddbmm(v_sq, q16, v16, beta=1.0, alpha=-2.0)  # |v|^2 - 2 q.v
        out[:, s:s + tile] = torch.argmin(d, dim=-1)
        del d
    return out


@torch.no_grad()
def nearest_vertex(query: torch.Tensor, verts: torch.Tensor, tile: int = 8192) -> torch.Tensor:
    """Index (M,) int64 of the nearest of ``verts`` (V, 3) to each point of
    ``query`` (M, 3), in fp32, ``tile`` points at a time."""
    v_sq = (verts * verts).sum(-1)
    out = torch.empty(query.shape[0], dtype=torch.long, device=query.device)
    for s in range(0, query.shape[0], tile):
        d = v_sq[None, :] - 2.0 * (query[s:s + tile] @ verts.T)
        out[s:s + tile] = torch.argmin(d, dim=-1)
    return out


def _inv_apply(m, x, y, z):
    """inv(R) @ [x, y, z] for R = [[m0 m1 m2], [m4 m5 m6], [m8 m9 m10]], by
    the closed-form adjugate (JAX canonical.py:88-101)."""
    A_ = m[5] * m[10] - m[6] * m[9]
    B_ = -(m[4] * m[10] - m[6] * m[8])
    C_ = m[4] * m[9] - m[5] * m[8]
    inv_det = 1.0 / (m[0] * A_ + m[1] * B_ + m[2] * C_)
    nx = (A_ * x - (m[1] * m[10] - m[2] * m[9]) * y
          + (m[1] * m[6] - m[2] * m[5]) * z) * inv_det
    ny = (B_ * x + (m[0] * m[10] - m[2] * m[8]) * y
          - (m[0] * m[6] - m[2] * m[4]) * z) * inv_det
    nz = (C_ * x - (m[0] * m[9] - m[1] * m[8]) * y
          + (m[0] * m[5] - m[1] * m[4]) * z) * inv_det
    return nx, ny, nz


@torch.no_grad()
def deform_to_canonical_batched(
    model: BodyModel,
    poses: torch.Tensor,
    betas: torch.Tensor,
    big_poses: torch.Tensor,
    smpl_verts: torch.Tensor,
    query_pts: torch.Tensor,
    query_dirs: Optional[torch.Tensor] = None,
    expression: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Inverse-LBS of ``query_pts`` (B, M, 3), in SMPL space, into the big
    pose, and of ``query_dirs`` (B, M, 3) by the rotations alone. poses and
    big_poses (B, J*3), betas (B, n), smpl_verts (B, V, 3): the posed
    vertices in SMPL space. Returns (points (B, M, 3), dirs or None)."""
    B, M = query_pts.shape[:2]
    V = smpl_verts.shape[1]
    t = model.tensors(query_pts.device)
    A, _ = transform_params(model, poses, betas, expression)  # (B, J, 4, 4)
    J = A.shape[1]
    vert_ids = nearest_vertex_batched(query_pts, smpl_verts)  # (B, M)
    bweights = t["weights"][vert_ids.reshape(-1)].reshape(B, M, J)

    def mat16(A_j):  # the blended per-point transform as 16 (B, M) components
        flat = torch.bmm(bweights, A_j.reshape(B, J, 16))
        return [flat[..., i] for i in range(16)]

    flat_ids = (vert_ids + (torch.arange(B, device=vert_ids.device) * V)[:, None]).reshape(-1)

    def gathered(offsets_bv3):  # (B, V, 3) -> three (B, M) components
        out = offsets_bv3.reshape(B * V, 3)[flat_ids].reshape(B, M, 3)
        return out[..., 0], out[..., 1], out[..., 2]

    m = mat16(A)
    cx, cy, cz = _inv_apply(m, query_pts[..., 0] - m[3], query_pts[..., 1] - m[7],
                            query_pts[..., 2] - m[11])
    if query_dirs is not None:
        dx, dy, dz = _inv_apply(m, query_dirs[..., 0], query_dirs[..., 1], query_dirs[..., 2])
    del m

    ox, oy, oz = gathered(_pose_offsets(model, batch_rodrigues(poses.reshape(B, -1, 3))))
    cx, cy, cz = cx - ox, cy - oy, cz - oz
    ox, oy, oz = gathered(torch.einsum("vdn,bn->bvd", t["shapedirs"], betas))
    cx, cy, cz = cx - ox, cy - oy, cz - oz
    ox, oy, oz = gathered(_pose_offsets(model, batch_rodrigues(big_poses.reshape(B, -1, 3))))
    cx, cy, cz = cx + ox, cy + oy, cz + oz

    A_big, _ = transform_params(model, big_poses, torch.zeros_like(betas), expression)
    mb = mat16(A_big)
    can = torch.stack([mb[0] * cx + mb[1] * cy + mb[2] * cz + mb[3],
                       mb[4] * cx + mb[5] * cy + mb[6] * cz + mb[7],
                       mb[8] * cx + mb[9] * cy + mb[10] * cz + mb[11]], dim=-1)
    if query_dirs is None:
        return can, None
    return can, torch.stack([mb[0] * dx + mb[1] * dy + mb[2] * dz,
                             mb[4] * dx + mb[5] * dy + mb[6] * dz,
                             mb[8] * dx + mb[9] * dy + mb[10] * dz], dim=-1)


def world_to_smpl(x: torch.Tensor, R: torch.Tensor, Th: torch.Tensor) -> torch.Tensor:
    """``(x - Th) @ R`` over batched points (B, M, 3), R (B, 3, 3), Th (B, 3)
    or (B, 1, 3) (renderer.py:129-134). The reference applies it to view
    directions too, translation included; so do both packages."""
    return torch.bmm(x - Th.reshape(-1, 1, 3), R)


def make_eval_deform_fn(model: BodyModel):
    """The eval and decode renderers' deform: ``deform(pts (M, 3), dirs (M,
    3) or None, args) -> (pts, dirs)`` where ``args`` holds one item's SMPL
    arrays (numpy or tensors): ``poses`` (J*3,), ``betas`` (n,), ``t_poses``
    (J*3,), ``R`` (3, 3), ``Th`` (1, 3) or (3,), ``smpl_verts`` (V, 3).
    World to SMPL space (dirs translated by Th too), then the batched
    inverse-LBS at B 1, as in JAX (renderer.py:124-140)."""

    def deform(pts, dirs, args):
        def arg(name):
            return torch.as_tensor(args[name], dtype=torch.float32).to(pts.device)

        R, Th = arg("R").reshape(1, 3, 3), arg("Th").reshape(1, 1, 3)
        can, cdirs = deform_to_canonical_batched(
            model, arg("poses").reshape(1, -1), arg("betas").reshape(1, -1),
            arg("t_poses").reshape(1, -1), arg("smpl_verts")[None],
            world_to_smpl(pts[None], R, Th),
            None if dirs is None else world_to_smpl(dirs[None], R, Th))
        return can[0], (None if cdirs is None else cdirs[0])

    return deform


@torch.no_grad()
def deform_to_canonical(
    model: BodyModel,
    poses: torch.Tensor,
    betas: torch.Tensor,
    big_poses: torch.Tensor,
    smpl_verts: torch.Tensor,
    query_pts: torch.Tensor,
    query_dirs: Optional[torch.Tensor] = None,
    expression: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One item's inverse-LBS (renderer.py:60-122): poses and big_poses
    (J*3,), betas (n,), smpl_verts (V, 3) and query_pts (M, 3) in SMPL space.
    The fp32 1-NN and an LU inverse of each point's blended rotation. Returns
    (points (M, 3), dirs (M, 3) or None)."""
    t = model.tensors(query_pts.device)
    expr_b = None if expression is None else expression[None]
    A, _ = transform_params(model, poses[None], betas[None], expr_b)
    J = A.shape[1]
    vert_ids = nearest_vertex(query_pts, smpl_verts)
    bweights = t["weights"][vert_ids]  # (M, J)

    A_pt = (bweights @ A[0].reshape(J, 16)).reshape(-1, 4, 4)
    R_inv = torch.linalg.inv(A_pt[:, :3, :3])
    can = (R_inv @ (query_pts - A_pt[:, :3, 3])[..., None])[..., 0]
    if query_dirs is not None:
        query_dirs = (R_inv @ query_dirs[..., None])[..., 0]

    can = can - _pose_offsets(model, batch_rodrigues(poses.reshape(1, -1, 3)))[0][vert_ids]
    can = can - torch.einsum("vdn,n->vd", t["shapedirs"], betas)[vert_ids]
    can = can + _pose_offsets(model, batch_rodrigues(big_poses.reshape(1, -1, 3)))[0][vert_ids]

    A_big, _ = transform_params(model, big_poses[None], torch.zeros_like(betas[None]), expr_b)
    A_pt = (bweights @ A_big[0].reshape(J, 16)).reshape(-1, 4, 4)
    can = (A_pt[:, :3, :3] @ can[..., None])[..., 0] + A_pt[:, :3, 3]
    if query_dirs is None:
        return can, None
    return can, (A_pt[:, :3, :3] @ query_dirs[..., None])[..., 0]
