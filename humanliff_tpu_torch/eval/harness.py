"""Stage-1 evaluation harness (port of ``humanliff_tpu/eval/harness.py``;
reference recon_NeRF/lib/all_test.py).

Renders held-out views per (subject, layer), writes pred/gt PNGs, computes
MSE/PSNR/SSIM (and LPIPS where ``eval/metrics.py::lpips_fn`` has its weights)
over the mask_at_box crop (all_test.py:19-42, :186-195), prints per-image wall-clock, and writes
``metrics_{tag}.json`` / ``metrics_{tag}.npy`` (:220-227). View selection
matches :100-109: base views [145, 165] offset by 5 x layer, or the 145-185
range for a single ``--test_layer_id``.

Canonical-space (TightCap) eval renders through ``deform_fn`` with each
view's ``deform_args_fn(item)`` (``bodymodel/canonical.py::make_eval_deform_fn``).
PNGs are written by the port's stdlib writer (``utils/video.py``), not
imageio.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from humanliff_tpu_torch.eval.metrics import lpips_fn, mse, ssim
from humanliff_tpu_torch.nerf.fastpath import GridCache, render_image_fast
from humanliff_tpu_torch.nerf.renderer import render_image_masked
from humanliff_tpu_torch.utils.video import write_png


def default_test_views(layer: int, test_layer_id: Optional[int] = None) -> List[int]:
    if test_layer_id is not None:
        return list(range(145, 186))
    return [145 + 5 * layer, 165 + 5 * layer]


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_views(
    decoder,
    planes: torch.Tensor,
    view_items: List[Dict[str, np.ndarray]],
    cfg,
    savedir: Optional[str] = None,
    chunk: int = 4096,
    tag: str = "subject",
    fast: bool = False,
    grid_resolution: int = 128,
    deform_fn=None,
    deform_args_fn=None,
) -> Dict[str, float]:
    """Render each full-image view item (a dataset's ``test_item``) with
    ``planes`` ``(3, C3, D, D)`` on their device and score it; returns the
    metrics averaged over the views.

    Only the ``ray_mask`` (mask_at_box) rays are rendered; the reference
    renders every pixel and zeroes the rest (all_test.py:178), so the outputs
    match. ``fast=True`` renders by the density-grid fast tier
    (``nerf/fastpath.py``: one grid per subject and box, empty rays
    terminated, exact fine pass). ``deform_fn`` enables canonical-space
    eval; ``deform_args_fn(item)`` gives its per-view SMPL arrays."""
    if savedir:
        os.makedirs(savedir, exist_ok=True)
    lpips = lpips_fn(planes.device)
    grids = GridCache(decoder, planes, resolution=grid_resolution) if fast and view_items else None
    rows = []
    for vi, item in enumerate(view_items):
        H, W = (int(item["hw"][0]), int(item["hw"][1]))
        t0 = time.time()
        dargs = None if deform_args_fn is None else deform_args_fn(item)
        if grids is not None:
            item_box = np.asarray(item["box_warp"], np.float32)
            out = render_image_fast(
                decoder, planes, grids.get(item_box), item["rays_o"], item["rays_d"],
                item["near"], item["far"], item["ray_mask"], item_box, cfg,
                chunk=max(chunk, 4096),
                # Terminated in-mask rays must match the exact tier's
                # background compositing, and acc/depth are unused downloads.
                bg_color=1.0 if cfg.white_bkgd else 0.0, outputs=("rgb",),
                deform_fn=deform_fn, deform_args=dargs,
            )
            if cfg.white_bkgd:
                # The exact tier (fill 0.0) and the reference protocol leave
                # out-of-mask pixels 0; only terminated in-mask rays
                # composite the white background.
                out_mask = torch.as_tensor(np.asarray(item["ray_mask"]).reshape(-1).astype(bool))
                out["rgb"][~out_mask.to(out["rgb"].device)] = 0.0
        else:
            out = render_image_masked(
                decoder, planes, item["rays_o"], item["rays_d"], item["near"], item["far"],
                item["ray_mask"], item["box_warp"], cfg, chunk=chunk,
                deform_fn=deform_fn, deform_args=dargs,
            )
        _sync(planes.device)
        rgb = out["rgb"].float().cpu().numpy().reshape(H, W, 3)
        dt = time.time() - t0
        print(f"[eval {tag}] view {vi}: time per image {dt:.2f}s")

        gt = np.asarray(item["rgb"]).reshape(H, W, 3)
        mask = np.asarray(item["ray_mask"]).reshape(H, W).astype(bool)
        # Reference scoring (all_test.py:19-42,186-195): MSE/PSNR over the mask
        # pixels only; SSIM over the mask's bounding-box crop with both images
        # zeroed outside the mask.
        gt_z = np.where(mask[..., None], gt, 0.0)
        if mask.any():
            ys, xs = np.where(mask)
            sl = (slice(ys.min(), ys.max() + 1), slice(xs.min(), xs.max() + 1))
            m = mse(rgb[mask], gt[mask])
        else:
            sl = (slice(None), slice(None))
            m = mse(rgb, gt_z)
        pred_c, gt_c = rgb[sl], gt_z[sl]

        row = {
            "mse": m,
            "psnr": -10.0 * float(np.log10(max(m, 1e-12))),
            "ssim": ssim(pred_c, gt_c),
            "time_s": dt,
        }
        if lpips is not None:
            row["lpips"] = lpips(pred_c, gt_c)
        rows.append(row)

        if savedir:
            write_png(os.path.join(savedir, f"{tag}_view{vi:03d}_pred.png"), to8b(rgb))
            write_png(os.path.join(savedir, f"{tag}_view{vi:03d}_gt.png"), to8b(gt))

    agg = {k: float(np.mean([r[k] for r in rows])) for k in rows[0] if k != "time_s"}
    agg["time_per_image_s"] = float(np.mean([r["time_s"] for r in rows]))
    if savedir:
        # Keyed by tag: one evaluation writes several (subject, layer) passes
        # into the same savedir (the reference writes one psnr/ssim/lpips txt
        # per run dir, all_test.py:220-227).
        with open(os.path.join(savedir, f"metrics_{tag}.json"), "w") as f:
            json.dump({"aggregate": agg, "per_view": rows}, f, indent=2)
        np.save(os.path.join(savedir, f"metrics_{tag}.npy"), rows)
    return agg
