"""The fast decode tier: a density grid in place of the coarse pass, and
termination of empty rays (port of ``humanliff_tpu/nerf/fastpath.py``).

1. :func:`build_density_grid` evaluates the frozen decoder's raw density on an
   (R+1)^3 lattice over the box once per (planes, decoder) and packs each
   cell's 2x2x2 trilinear corners into one row, so a lookup is one 8-wide
   gather instead of the nine-plane sampler and the MLP.
2. :func:`render_image_fast` places each ray's fine samples from the grid's
   densities (the coarse pass's weight math, deterministic ``sample_pdf``) and
   drops the rays whose grid-estimated accumulated alpha stays at or below
   ``early_term_eps`` before the fine pass. The fine pass is exact: the same
   sampler, decoder and compositing as :func:`nerf.renderer.render_rays`.

Every decoder evaluation goes through the fused decoder kernel on CUDA: the
grid build (density-only, one launch per ``build_chunk`` lattice points) and
each fine tile (full, one launch per ``chunk`` kept rays). The JAX package's
host readback of the active-ray bitmap, its host-side scatter, its padding of
tiles to whole shapes and its serialisation were for a slow host link to the
TPU; here the rays are compacted and scattered on the device.

Canonical space (TightCap): the grid lives in the planes' own (canonical)
space and is built without the deform; the coarse phase deforms its sample
points before the grid lookup, and the fine pass its points and directions,
through ``deform_fn`` (and ``deform_args``) as in ``nerf/renderer.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from humanliff_tpu_torch.nerf.renderer import (
    RenderConfig,
    bind_deform,
    masked_rays,
    shade_rays,
)
from humanliff_tpu_torch.ops.sampling import (
    coarse_weights,
    merge_z_vals,
    sample_pdf,
    stratified_z_vals,
)
from humanliff_tpu_torch.ops.triplane import sample_triplane_features


@dataclasses.dataclass(frozen=True, eq=False)
class DensityGrid:
    """Corner-packed trilinear density table over a box.

    ``table`` is ``((R+1)^3, 8)`` in the planes' dtype on their device: row
    (k, j, i), with i along x, holds the raw (pre-softplus) densities at the
    corners (i + dx, j + dy, k + dz) of the (R+1)-point lattice, edge-clamped,
    in the order dz, dy, dx (dx fastest).
    """

    table: torch.Tensor
    resolution: int


@torch.no_grad()
def build_density_grid(decoder, planes: torch.Tensor, box_warp, resolution: int = 128,
                       build_chunk: int = 1 << 22) -> DensityGrid:
    """Raw density on the (R+1)^3 lattice spanning ``box_warp``, corner-packed.

    The lattice is made on the planes' device in (z, y, x) order; features go
    to the decoder in the planes' dtype, ``build_chunk`` points per call.
    """
    R = resolution
    device = planes.device
    box_np = np.asarray(box_warp, np.float32)
    box = torch.from_numpy(box_np).to(device)
    lin = [torch.linspace(float(box_np[0, d]), float(box_np[1, d]), R + 1, device=device)
           for d in range(3)]
    n = (R + 1) ** 3
    dens = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, build_chunk):
        i = torch.arange(s, min(s + build_chunk, n), device=device)
        pts = torch.stack([lin[0][i % (R + 1)], lin[1][(i // (R + 1)) % (R + 1)],
                           lin[2][i // (R + 1) ** 2]], dim=-1)
        feats = sample_triplane_features(planes, pts, box).to(planes.dtype)
        dens[s:s + i.numel()] = decoder(feats)[1][:, 0]
    d = dens.reshape(R + 1, R + 1, R + 1)  # (z, y, x)
    dpad = torch.cat([d, d[-1:]], 0)
    dpad = torch.cat([dpad, dpad[:, -1:]], 1)
    dpad = torch.cat([dpad, dpad[:, :, -1:]], 2)
    corners = [dpad[dz:dz + R + 1, dy:dy + R + 1, dx:dx + R + 1]
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    table = torch.stack(corners, dim=-1).reshape(n, 8).to(planes.dtype)
    return DensityGrid(table=table, resolution=R)


def sample_grid_density(grid: DensityGrid, pts: torch.Tensor,
                        box_warp: torch.Tensor) -> torch.Tensor:
    """Trilinear raw density (M,) fp32 at ``pts`` (M, 3): one 8-wide gather
    per point. The fractions are cast to the table's dtype and the corners
    summed in it, as the JAX package does."""
    R = grid.resolution
    lo, hi = box_warp[0], box_warp[1]
    u = ((pts - lo) / (hi - lo) * R).clamp(0.0, float(R) - 1e-4)
    i0 = torch.floor(u)
    f = (u - i0).to(grid.table.dtype)
    i0 = i0.long()
    rows = grid.table[(i0[:, 2] * (R + 1) + i0[:, 1]) * (R + 1) + i0[:, 0]]  # (M, 8)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    wx = torch.stack([1 - fx, fx], -1)
    wy = torch.stack([1 - fy, fy], -1)
    wz = torch.stack([1 - fz, fz], -1)
    w = (wz[:, :, None, None] * wy[:, None, :, None] * wx[:, None, None, :]).reshape(-1, 8)
    return (rows * w).sum(-1).float()


class GridCache:
    """One density grid per (decoder, planes), rebuilt when the box changes."""

    def __init__(self, decoder, planes: torch.Tensor, resolution: int = 128):
        self._args = (decoder, planes, resolution)
        self._box = None
        self._grid = None

    def get(self, box_warp) -> DensityGrid:
        box = np.asarray(box_warp, np.float32)
        if self._grid is None or not np.array_equal(box, self._box):
            decoder, planes, res = self._args
            self._grid = build_density_grid(decoder, planes, box, resolution=res)
            self._box = box
        return self._grid


def coarse_from_grid(grid: DensityGrid, rays_o, rays_d, near, far, box_warp,
                     cfg: RenderConfig, deform: Optional[Callable] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid's coarse phase for (R,) rays: the merged, sorted depths
    (R, n_samples + n_importance) and each ray's estimated accumulated alpha
    (R,), summed without the 1e10 tail interval. ``deform`` ``(pts, None) ->
    (pts, None)`` moves the sample points into the grid's frame first."""
    z = stratified_z_vals(near, far, cfg.n_samples)
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    if deform is not None:
        pts, _ = deform(pts, None)
    dens = sample_grid_density(grid, pts, box_warp).reshape(z.shape)
    weights = coarse_weights(dens, z, rays_d)
    new_z = sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]), weights[..., 1:-1],
                       cfg.n_importance)
    return merge_z_vals(z, new_z), weights[..., :-1].sum(-1)


@torch.no_grad()
def render_image_fast(
    decoder,
    planes: torch.Tensor,
    grid: DensityGrid,
    rays_o,
    rays_d,
    near,
    far,
    mask,
    box_warp,
    cfg: RenderConfig,
    chunk: int = 16384,
    early_term_eps: float = 1e-2,
    bg_color: float = 0.0,
    outputs: Tuple[str, ...] = ("rgb", "acc", "depth"),
    max_rays_in_flight: int = 1 << 21,
    coarse_chunk: int = 1 << 18,
    deform_fn: Optional[Callable] = None,
    deform_args=None,
) -> Dict[str, torch.Tensor]:
    """Full-image render of the in-box rays: the grid's coarse phase, then the
    exact fine pass on the rays it keeps. Same layout as
    ``render_image_masked``: ``{name: tensor}`` on the planes' device, rgb
    (N, 3), acc (N,), depth (N,); off-box and terminated rays keep ``bg_color``
    and zero acc and depth.

    Any number of rays is accepted (e.g. 40 views concatenated): groups of
    ``max_rays_in_flight`` rays go through both phases in turn, which bounds
    the per-ray depths held on the device (rays x (n_samples + n_importance)
    x 4 B: 2.1 GB for 2M rays at 128 + 128). The coarse phase runs
    ``coarse_chunk`` rays at a time, the fine pass ``chunk``. ``deform_fn``
    and ``deform_args``: canonical space (module docstring).
    """
    deform = bind_deform(deform_fn, deform_args)
    idx_all, (ro, rd, nr, fr), box, full = masked_rays(
        planes.device, rays_o, rays_d, near, far, mask, box_warp, bg_color, outputs)
    eval_cfg = dataclasses.replace(cfg, perturb=False, density_noise=False)
    group = max(chunk, (max_rays_in_flight // chunk) * chunk)
    for g0 in range(0, idx_all.shape[0], group):
        g = slice(g0, g0 + group)
        z_tiles, keep_tiles = [], []
        for s in range(g0, min(g0 + group, idx_all.shape[0]), coarse_chunk):
            sl = slice(s, min(s + coarse_chunk, g0 + group))
            z_t, acc_est = coarse_from_grid(grid, ro[sl], rd[sl], nr[sl], fr[sl], box,
                                            eval_cfg, deform)
            z_tiles.append(z_t)
            keep_tiles.append(acc_est > early_term_eps)
        z_all = torch.cat(z_tiles)
        del z_tiles
        keep = torch.nonzero(torch.cat(keep_tiles))[:, 0]  # group-local indices
        for s in range(0, keep.shape[0], chunk):
            t = keep[s:s + chunk]
            tg = t + g0
            out = shade_rays(decoder, planes, ro[tg], rd[tg], nr[tg], fr[tg], z_all[t], box,
                             eval_cfg.white_bkgd, deform=deform)
            dest = idx_all[g][t]
            for k in full:
                full[k][dest] = out[k]
        del z_all
    return full
