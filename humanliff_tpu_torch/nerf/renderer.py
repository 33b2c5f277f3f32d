"""Tri-plane NeRF volume renderer (port of ``humanliff_tpu/nerf/renderer.py``).

``render_rays`` is the per-chunk render core (reference renderer.py:180-295):
a density-only coarse pass (no gradients), importance sampling of the fine
depths, then the full decoder and alpha compositing. Parity quirks kept: the
coarse up-sampler scales z widths by ``||d||`` while the fine-pass alpha uses
raw widths, and depth is normalized by near/far (renderer.py:288).

``render_image_masked`` renders only the rays whose AABB test passed. The rays
are uploaded once and compacted, rendered chunk by chunk and scattered back on
the device; the JAX package's host-side scatter was a workaround for a slow
host link to the TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from humanliff_tpu_torch.ops.compositing import composite_rays
from humanliff_tpu_torch.ops.sampling import (
    merge_z_vals,
    stratified_z_vals,
    upsample_z_vals,
)
from humanliff_tpu_torch.ops.triplane import sample_triplane_features


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_samples: int = 128
    n_importance: int = 128
    perturb: bool = True
    white_bkgd: bool = False
    density_noise: bool = True  # reference training-time alpha noise


def features_along(planes: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                   z_vals: torch.Tensor, box_warp: torch.Tensor) -> torch.Tensor:
    """``(R * S, 27)`` features at the points ``o + z d`` in the planes' dtype;
    with batched planes ``(B, 3, C3, D, D)`` (rays ``(B, R, 3)``, depths
    ``(B, R, S)``, ``box_warp`` ``(B, 2, 3)``) the ``(B * R * S, 27)`` of all
    items, for one decoder call."""
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., None]
    pts = pts.reshape(-1, 3) if planes.dim() == 4 else pts.reshape(planes.shape[0], -1, 3)
    feats = sample_triplane_features(planes, pts, box_warp).to(planes.dtype)
    return feats.reshape(-1, feats.shape[-1])


def shade_rays(
    decoder,
    planes: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    z_vals: torch.Tensor,
    box_warp: torch.Tensor,
    white_bkgd: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """The fine pass at the depths ``z_vals`` ``(..., R, S)``: the full
    decoder, sigmoid rgb, compositing (density noise from ``generator`` if
    given) and depth normalized by near/far (renderer.py:271-288)."""
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dirs = viewdirs[..., None, :].expand(*z_vals.shape, 3).reshape(-1, 3).to(planes.dtype)
    rgb_raw, dens_raw = decoder(features_along(planes, rays_o, rays_d, z_vals, box_warp), dirs)
    rgb = torch.sigmoid(rgb_raw).reshape(*z_vals.shape, 3)
    dens = dens_raw[:, 0].reshape(z_vals.shape)
    rgb_map, acc_map, depth_map = composite_rays(
        rgb, dens, z_vals, generator=generator, white_bkgd=white_bkgd
    )
    depth_map = (depth_map - near) / (far - near + 1e-5)
    return {"rgb": rgb_map, "acc": acc_map, "depth": depth_map}


def render_rays(
    decoder,
    planes: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    box_warp: torch.Tensor,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Render ``(R, 3)`` rays against one ``(3, C3, D, D)`` tri-plane.

    ``decoder`` is a :class:`~humanliff_tpu_torch.nerf.decoder.NeRFDecoder`
    (or any callable ``(feats, dirs=None) -> (rgb_raw, alpha_raw)``).
    Features and directions reach the decoder in the planes' dtype (bf16
    planes give the kernel bf16 inputs). ``generator`` drives stratified
    jitter, random fine sampling and density noise, in that order; None is the
    deterministic eval path. Returns rgb (R, 3), acc (R,), depth (R,)
    normalized by near/far. Batched planes take the shapes of
    :func:`render_rays_batch`.
    """
    g_strat = generator if cfg.perturb else None
    z_vals = stratified_z_vals(near, far, cfg.n_samples, generator=g_strat)

    if cfg.n_importance > 0:
        with torch.no_grad():  # coarse pass: density only (renderer.py:258-269)
            _, dens = decoder(features_along(planes, rays_o, rays_d, z_vals, box_warp))
            dens = dens[:, 0].reshape(z_vals.shape)
            new_z = upsample_z_vals(dens, z_vals, rays_d, cfg.n_importance,
                                    generator=generator)
            z_vals = merge_z_vals(z_vals, new_z)

    return shade_rays(decoder, planes, rays_o, rays_d, near, far, z_vals, box_warp,
                      cfg.white_bkgd, generator if cfg.density_noise else None)


def render_rays_batch(
    decoder,
    planes: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    box_warp: torch.Tensor,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """The natively batched render of Stage-1 training (renderer.py:144-219):
    planes ``(B, 3, C3, D, D)``, rays ``(B, R, 3)``, near/far ``(B, R)``,
    ``box_warp`` ``(B, 2, 3)``. Each pass is one decoder call over all
    ``B * R * S`` points (one kernel launch), the coarse pass without
    gradients. Returns rgb (B, R, 3), acc (B, R), depth (B, R)."""
    B, R = rays_o.shape[:2]
    if planes.dim() != 5 or planes.shape[0] != B or tuple(box_warp.shape) != (B, 2, 3):
        raise ValueError(f"batched render: planes {tuple(planes.shape)}, rays "
                         f"{tuple(rays_o.shape)}, box_warp {tuple(box_warp.shape)}")
    return render_rays(decoder, planes, rays_o, rays_d, near, far, box_warp, cfg, generator)


def masked_rays(device, rays_o, rays_d, near, far, mask, box_warp, bg_color: float,
                outputs: Tuple[str, ...]):
    """Upload a full image's rays once and compact them to the ones in the box.

    Returns the in-box ray indices ``idx`` (on ``device``), the compacted
    (rays_o, rays_d, near, far), the box, and the full-image outputs to
    scatter into: ``bg_color`` rgb (N, 3), zero acc (N,) and depth (N,), as
    the reference zeroes off-box pixels (all_test.py:178).
    """
    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    N = np.asarray(mask).size
    sel = torch.as_tensor(np.asarray(mask).reshape(-1).astype(bool)).to(device)
    idx = torch.nonzero(sel)[:, 0]
    rays = tuple(dev(a)[idx] for a in (rays_o, rays_d, near, far))
    full = {
        "rgb": torch.full((N, 3), bg_color, dtype=torch.float32, device=device),
        "acc": torch.zeros((N,), dtype=torch.float32, device=device),
        "depth": torch.zeros((N,), dtype=torch.float32, device=device),
    }
    return idx, rays, dev(box_warp), {k: full[k] for k in outputs}


@torch.no_grad()
def render_image_masked(
    decoder,
    planes: torch.Tensor,
    rays_o,
    rays_d,
    near,
    far,
    mask,
    box_warp,
    cfg: RenderConfig,
    chunk: int = 16384,
    bg_color: float = 0.0,
    outputs: Tuple[str, ...] = ("rgb", "acc", "depth"),
) -> Dict[str, torch.Tensor]:
    """Full-image eval render that computes only the rays inside the box.

    Ray arrays are the host numpy arrays of ``full_image_rays`` (or tensors);
    they go to ``planes.device`` once. Off-box pixels get ``bg_color`` (rgb)
    and zero acc/depth, as the reference zeroes them (all_test.py:178).
    Returns ``{name: tensor}`` on the planes' device: rgb (N, 3), acc (N,),
    depth (N,). Deterministic: no jitter, no density noise.
    """
    idx, (ro, rd, nr, fr), box, full = masked_rays(planes.device, rays_o, rays_d, near,
                                                   far, mask, box_warp, bg_color, outputs)
    eval_cfg = dataclasses.replace(cfg, perturb=False, density_noise=False)
    for s in range(0, idx.shape[0], chunk):
        sl = slice(s, s + chunk)
        out = render_rays(decoder, planes, ro[sl], rd[sl], nr[sl], fr[sl], box, eval_cfg)
        for k in full:
            full[k][idx[sl]] = out[k]
    return full
