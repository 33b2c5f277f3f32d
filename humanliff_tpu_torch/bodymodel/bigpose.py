"""The shared canonical "big pose": 45 degree legs, 30 degree arms (port of
``humanliff_tpu/bodymodel/bigpose.py``; reference recon_NeRF/lib/renderer.py:50-58).

Pose entries 5, 8 (hip z-rotations) and 23, 26 (shoulder z-rotations) of the
72-d SMPL pose vector; SMPL-X (165-d) has the same joint-local indices.
"""

from __future__ import annotations

import numpy as np


def big_pose_params(pose_dim: int = 72, dtype=np.float32) -> np.ndarray:
    """The canonical big-pose axis-angle vector of length ``pose_dim``."""
    pose = np.zeros(pose_dim, dtype=dtype)
    for idx, deg in ((5, 45.0), (8, -45.0), (23, -30.0), (26, 30.0)):
        if idx < pose_dim:  # toy models with few joints skip arm entries
            pose[idx] = np.deg2rad(deg)
    return pose
