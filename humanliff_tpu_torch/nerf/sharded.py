"""Novel-view decoding with the rays' tiles split over a mesh of ranks (port of
``humanliff_tpu/nerf/sharded.py``).

The decode workload (the reference's 25 samples x 4 layers x 40 views at 512^2
with 128 + 128 samples a ray, triplane_sample_layered.py:155-176) is parallel
across rays. The reference splits inference across ranks (:211-219); here the
masked rays of all the requested views tile into fixed ``chunk``-ray blocks
(no longer than the largest view's masked rays, so small views pad less than
under JAX's fixed chunk), tiles never spanning views, the tile count padded
to a multiple of the mesh size with copies of the first tile, and rank r
renders the r-th contiguous block of tiles with the exact tile renderer
(``nerf/renderer.py::render_rays``, eval config: no jitter, no density
noise), two decoder launches a tile.
Planes and the decoder are whole on every rank; the only communication is
the gather of the tiles' compact outputs, after which every rank scatters
them back into per-view images. The result is :func:`render_image_masked`'s
per view, but for the padding of a view's last tile, which renders copies of
its first ray.

Canonical (TightCap) decode: each tile renders with its own view's deform
arguments (``deform_args_fn(item)``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from humanliff_tpu_torch.nerf.renderer import RenderConfig, render_rays
from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import DataMesh


def _blank(N: int, outputs: Tuple[str, ...], bg_color: float, device) -> Dict[str, torch.Tensor]:
    return {k: torch.full((N, 3) if k == "rgb" else (N,), bg_color if k == "rgb" else 0.0,
                          dtype=torch.float32, device=device) for k in outputs}


@torch.no_grad()
def render_views_sharded(
    decoder,
    planes: torch.Tensor,
    view_items: List[Dict[str, np.ndarray]],
    cfg: RenderConfig,
    mesh: DataMesh,
    chunk: int = 16384,
    deform_fn: Optional[Callable] = None,
    deform_args_fn: Optional[Callable] = None,
    bg_color: float = 0.0,
    outputs: Tuple[str, ...] = ("rgb",),
) -> List[Dict[str, torch.Tensor]]:
    """Render every view item's masked rays with the tiles split over ``mesh``:
    tiles of ``chunk`` rays, or of the largest view's masked rays where fewer.

    ``view_items`` follow the eval harness's schema (rays_o / rays_d / near /
    far / ray_mask and box_warp, host arrays); ``deform_args_fn(item)`` gives
    a view's SMPL arrays for canonical decode. Returns one dict per view, on
    every rank, of tensors on the planes' device in the flat layout of
    ``render_image_masked`` (rgb (N, 3), acc and depth (N,)).

    All views must share ``box_warp`` (one tri-plane space a call: true for a
    (sample, layer) decode; SynBody's per-pose boxes go in per-call groups).
    """
    device = planes.device
    box_np = np.asarray(view_items[0]["box_warp"], np.float32)
    for it in view_items[1:]:
        if not np.array_equal(np.asarray(it["box_warp"], np.float32), box_np):
            raise ValueError("render_views_sharded needs a shared box_warp; "
                             "group views by box first")

    # ---- The tile grid (tiles never span views) ----
    masks = [np.asarray(it["ray_mask"]).reshape(-1).astype(bool) for it in view_items]
    # No tile is longer than the largest view's masked rays: small views pad less.
    chunk = max(1, min(chunk, max(int(m.sum()) for m in masks)))
    per_view: List[Tuple[np.ndarray, int, int]] = []  # (idx, n_tiles, N pixels)
    cols: Dict[str, List[np.ndarray]] = {k: [] for k in ("rays_o", "rays_d", "near", "far")}
    tile_dargs: List = []
    for item, mask in zip(view_items, masks):
        idx = np.flatnonzero(mask)
        if idx.shape[0] == 0:
            per_view.append((idx, 0, mask.shape[0]))
            continue
        idx_p = np.concatenate([idx, np.full(((-idx.shape[0]) % chunk,), idx[0], idx.dtype)])
        n_tiles = idx_p.shape[0] // chunk
        for k in cols:
            arr = np.asarray(item[k], np.float32)
            cols[k].append(arr.reshape(arr.shape[0], -1)[idx_p].reshape(
                n_tiles, chunk, *arr.shape[1:]))
        tile_dargs += [None if deform_args_fn is None else deform_args_fn(item)] * n_tiles
        per_view.append((idx, n_tiles, mask.shape[0]))

    total = sum(t for _, t, _ in per_view)
    if total == 0:
        return [_blank(N, outputs, bg_color, device) for _, _, N in per_view]
    grid = {k: np.concatenate(v) for k, v in cols.items()}
    pad = (-total) % mesh.size  # dummy tiles: copies of the first
    if pad:
        grid = {k: np.concatenate([v, np.repeat(v[:1], pad, 0)]) for k, v in grid.items()}
        tile_dargs += [tile_dargs[0]] * pad

    # ---- This rank's block of tiles ----
    mine = mesh.rows(total + pad)
    rays = {k: torch.from_numpy(np.ascontiguousarray(v[mine])).to(device)
            for k, v in grid.items()}
    box = torch.from_numpy(box_np).to(device)
    eval_cfg = dataclasses.replace(cfg, perturb=False, density_noise=False)
    local = {k: [] for k in outputs}
    for j, t in enumerate(range(mine.start, mine.stop)):
        out = render_rays(decoder, planes, rays["rays_o"][j], rays["rays_d"][j],
                          rays["near"][j], rays["far"][j], box, eval_cfg,
                          deform_fn=deform_fn, deform_args=tile_dargs[t])
        for k in outputs:
            local[k].append(out[k].float())
    tiles = {k: coll.gather_rows(torch.stack(v), mesh) for k, v in local.items()}

    # ---- Scatter the tiles back into per-view images ----
    results, t0 = [], 0
    for idx, n_tiles, N in per_view:
        res = _blank(N, outputs, bg_color, device)
        if n_tiles:
            sel = torch.from_numpy(idx).to(device)
            for k in outputs:
                flat = tiles[k][t0:t0 + n_tiles].reshape(n_tiles * chunk, *res[k].shape[1:])
                res[k][sel] = flat[:idx.shape[0]]
            t0 += n_tiles
        results.append(res)
    return results
