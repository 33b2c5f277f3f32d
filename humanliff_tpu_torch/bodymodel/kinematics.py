"""Forward kinematics along a static kinematic tree (port of
``humanliff_tpu/bodymodel/kinematics.py``; reference renderer.py:403-433,
smplx/lbs.py:349).

The tree is a Python loop over ``parents``: ``chain[i] = chain[parents[i]] @
local[i]``. ``parents[0]`` is the root and points at itself (SMPL's
``kintree_table[0][0]`` convention); it is never read.
"""

from __future__ import annotations

import numpy as np
import torch


def rigid_transform_chain(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: np.ndarray) -> torch.Tensor:
    """World transforms ``(B, J, 4, 4)`` per joint from local rotations
    ``(B, J, 3, 3)`` and rest joints ``(B, J, 3)``, with the rest joint's
    translation folded in (renderer.py:428-431): ``A @ [p, 1]`` skins a
    rest-pose point bound to that joint."""
    parents = np.asarray(parents)
    B, J = joints.shape[:2]
    rel_joints = joints - torch.cat(
        [torch.zeros_like(joints[:, :1]), joints[:, parents[1:]]], dim=1)
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)
    bottom = joints.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, J, 1, 4)
    local = torch.cat([top, bottom], dim=-2)

    chain = [local[:, 0]]
    for i in range(1, J):
        chain.append(chain[int(parents[i])] @ local[:, i])
    transforms = torch.stack(chain, dim=1)

    # Subtract the transformed rest joint so A acts on rest-pose points.
    joints_h = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    shifted = (transforms * joints_h[:, :, None, :]).sum(-1)  # (B, J, 4)
    return torch.cat([transforms[..., :3], (transforms[..., 3] - shifted)[..., None]], dim=-1)
