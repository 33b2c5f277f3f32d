"""Axis-angle to rotation matrices (Rodrigues), batched (port of
``humanliff_tpu/bodymodel/rotations.py``; reference renderer.py:435-486,
smplx/lbs.py:299), with the +1e-8 angle regularisation that keeps the zero
pose differentiable."""

from __future__ import annotations

import torch


def batch_rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` axis-angle vectors to ``(..., 3, 3)`` rotation matrices."""
    shape = rot_vecs.shape[:-1]
    rv = rot_vecs.reshape(-1, 3)
    angle = torch.linalg.norm(rv + 1e-8, dim=1, keepdim=True)
    rot_dir = rv / angle
    cos = torch.cos(angle)[:, :, None]
    sin = torch.sin(angle)[:, :, None]
    rx, ry, rz = rot_dir[:, 0], rot_dir[:, 1], rot_dir[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=1).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=rv.dtype, device=rv.device)
    rot = ident + sin * K + (1.0 - cos) * (K @ K)
    return rot.reshape(*shape, 3, 3)
