"""Density grid and mesh extraction (port of ``humanliff_tpu/nerf/geometry.py``;
reference lib/renderer.py:304-349).

The raw density is evaluated on a resolution^3 lattice over ``bounds`` on the
planes' device, ``chunk`` points per decoder call (the fused decoder's
density-only kernel on CUDA), and the whole grid comes to the host once. The
surface is that of the negated density at iso 0 after one smoothing pass
(mcubes' convention: values below iso are inside), rescaled into ``bounds``.
A ``deform_fn`` ``(pts, None) -> (pts, None)`` moves the lattice points before
the lookup (JAX geometry.py:54-55); a view's deform binds its arguments with
``nerf.renderer.bind_deform``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from humanliff_tpu_torch.mesh.marching_cubes import marching_cubes, smooth_grid
from humanliff_tpu_torch.ops.triplane import sample_triplane_features


@torch.no_grad()
def eval_density_grid(decoder, planes: torch.Tensor, bounds, resolution: int = 512,
                      chunk: int = 1 << 22, deform_fn: Optional[Callable] = None
                      ) -> np.ndarray:
    """Raw density ``grid[x, y, z]`` (resolution^3, fp32 numpy) over ``bounds``
    (2, 3). The lattice is ``np.linspace`` in fp32 per axis, as in the JAX
    package; features reach the decoder in fp32 whatever the planes' dtype."""
    n = resolution
    device = planes.device
    bounds = np.asarray(bounds, np.float32)
    lin = [torch.from_numpy(np.linspace(bounds[0][d], bounds[1][d], n, dtype=np.float32))
           .to(device) for d in range(3)]
    box = torch.from_numpy(bounds).to(device)
    grid = torch.empty(n ** 3, dtype=torch.float32, device=device)
    for s in range(0, n ** 3, chunk):
        i = torch.arange(s, min(s + chunk, n ** 3), device=device)
        pts = torch.stack([lin[0][i // (n * n)], lin[1][(i // n) % n], lin[2][i % n]], dim=-1)
        if deform_fn is not None:
            pts, _ = deform_fn(pts, None)
        grid[s:s + i.numel()] = decoder(sample_triplane_features(planes, pts, box))[1][:, 0]
    return grid.reshape(n, n, n).cpu().numpy()


def extract_mesh(decoder, planes: torch.Tensor, bounds, resolution: int = 512,
                 threshold: float = 0.0, smooth_iters: int = 1,
                 deform_fn: Optional[Callable] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Marching-cubes mesh of the density field: verts (V, 3) in the
    coordinates of ``bounds`` and tris (T, 3) (renderer.py:341-348)."""
    u = -eval_density_grid(decoder, planes, bounds, resolution, deform_fn=deform_fn)
    if smooth_iters:
        u = smooth_grid(u, iters=smooth_iters)
    verts, tris = marching_cubes(u, iso=threshold)
    b_min = np.asarray(bounds[0], np.float32)
    b_max = np.asarray(bounds[1], np.float32)
    verts = verts / (resolution - 1.0) * (b_max - b_min)[None] + b_min[None]
    return verts, tris
