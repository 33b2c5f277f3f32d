"""Layered-chain fidelity (port of ``humanliff_tpu/eval/fidelity.py``).

Layer k of the chain should extend its conditioning layer k-1: new garment
content in a localized change region, everything outside it preserved
(triplane_sample_layered.py:124-151).

- :func:`plane_fidelity` / :func:`chain_fidelity_report`: tri-plane space; the
  change region is the set of texels whose max-channel |difference| exceeds
  ``threshold``.
- :func:`decoded_fidelity`: image space, two renders of consecutive layers
  through the frozen Stage-1 decoder (numpy only).
- :func:`heldout_denoise_loss`: the diffusion loss per layer of a model on
  held-out planes over a deterministic timestep grid.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _psnr(mse: float) -> float:
    return -10.0 * float(np.log10(max(mse, 1e-12)))


def plane_fidelity(x_k: np.ndarray, x_cond: np.ndarray,
                   threshold: float = 0.1) -> Dict[str, float]:
    """Change fraction, and L1 and PSNR outside the change region, between a
    generated layer ``x_k`` (H, W, C in [-1, 1]) and its conditioning ``x_cond``."""
    x_k = np.asarray(x_k, np.float32)
    x_cond = np.asarray(x_cond, np.float32)
    diff = np.abs(x_k - x_cond)
    changed = diff.max(axis=-1) > threshold  # (H, W)
    outside = ~changed
    if not outside.any():
        return {"change_fraction": 1.0, "outside_l1": float("nan"), "outside_psnr": 0.0}
    sel = diff[outside]  # (n_out, C)
    return {
        "change_fraction": float(changed.mean()),
        "outside_l1": float(sel.mean()),
        "outside_psnr": _psnr(float((sel ** 2).mean())),
    }


def batch_fidelity(x_k: np.ndarray, x_cond: np.ndarray,
                   threshold: float = 0.1) -> Dict[str, float]:
    """:func:`plane_fidelity` averaged over a batch (B, H, W, C)."""
    rows = [plane_fidelity(x_k[i], x_cond[i], threshold) for i in range(x_k.shape[0])]
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}


def chain_fidelity_report(layer_samples: Dict[str, np.ndarray],
                          threshold: float = 0.1) -> Dict[str, Dict[str, float]]:
    """:func:`batch_fidelity` of every consecutive (layer k-1 -> k) pair of a
    chain ``{layer_name: (B, H, W, C)}``, keyed ``"prev->cur"``."""
    names = list(layer_samples)
    return {f"{prev}->{cur}": batch_fidelity(np.asarray(layer_samples[cur]),
                                             np.asarray(layer_samples[prev]), threshold)
            for prev, cur in zip(names[:-1], names[1:])}


def decoded_fidelity(rgb_k: np.ndarray, acc_k: np.ndarray, rgb_km1: np.ndarray,
                     acc_km1: np.ndarray, threshold: float = 0.05,
                     occ: float = 0.5) -> Dict[str, float]:
    """Image-space chain consistency from two renders of consecutive layers
    (same camera, same decoder), flat (N, 3) rgb and (N,) acc maps: the
    changed-pixel fraction, the PSNR over the unchanged pixels, and occupancy
    persistence (where layer k-1 was occupied, layer k keeps acc >= acc_{k-1}
    - 0.1: later layers may add geometry but not erase the body)."""
    rgb_k = np.asarray(rgb_k, np.float32).reshape(-1, 3)
    rgb_km1 = np.asarray(rgb_km1, np.float32).reshape(-1, 3)
    acc_k = np.asarray(acc_k, np.float32).reshape(-1)
    acc_km1 = np.asarray(acc_km1, np.float32).reshape(-1)

    changed = np.abs(rgb_k - rgb_km1).max(axis=-1) > threshold
    outside = ~changed
    mse = float(((rgb_k[outside] - rgb_km1[outside]) ** 2).mean()) if outside.any() else 1.0

    body = acc_km1 > occ  # pixels the previous layer occupied
    persistence = float((acc_k[body] > acc_km1[body] - 0.1).mean()) if body.any() else 1.0
    return {
        "changed_pixel_fraction": float(changed.mean()),
        "unchanged_psnr": _psnr(mse),
        "occupancy_persistence": persistence,
    }


@torch.no_grad()
def heldout_denoise_loss(
    model,
    diffusion,
    items: List[Dict[str, np.ndarray]],
    generator: Optional[torch.Generator] = None,
    n_timesteps: int = 16,
    noise: Optional[Sequence[Sequence[np.ndarray]]] = None,
) -> Dict[int, float]:
    """Mean diffusion loss per layer index over plane items ({"x", "x_cond",
    "y"}, NHWC, the triplane dataset's schema).

    Timesteps are the stratified grid ``linspace(0, T - 1, n_timesteps)``
    rounded, the same for every item, so the number compares across
    checkpoints. Each (item, timestep) is one forward of batch 1 in eval mode
    (bf16 autocast on CUDA, as the sampler runs the UNet). ``noise[i][j]``
    (x's shape) is item i's noise at timestep j; without it the noise comes
    from ``generator``. Everything runs on the model's device.
    """
    from humanliff_tpu_torch.train.stage2 import model_fn_for

    device = next(model.parameters()).device
    T = diffusion.num_timesteps
    ts = np.linspace(0, T - 1, n_timesteps).round().astype(np.int64)
    model.eval()
    model_fn = model_fn_for(model)
    by_layer: Dict[int, List[float]] = {}
    for i, item in enumerate(items):
        x = torch.from_numpy(np.array(item["x"], np.float32))[None].to(device)
        xc = torch.from_numpy(np.array(item["x_cond"], np.float32))[None].to(device)
        y = torch.full((1,), int(item["y"]), dtype=torch.int64, device=device)
        losses = []
        for j, t in enumerate(ts):
            eps = (None if noise is None
                   else torch.from_numpy(np.array(noise[i][j], np.float32)).reshape(x.shape)
                   .to(device))
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=device.type == "cuda"):
                terms = diffusion.training_losses(
                    model_fn, x, xc, torch.full((1,), int(t), dtype=torch.int64, device=device),
                    model_kwargs={"y": y}, noise=eps, generator=generator)
            losses.append(float(terms["loss"].mean()))
        by_layer.setdefault(int(item["y"]), []).append(float(np.mean(losses)))
    return {k: float(np.mean(v)) for k, v in sorted(by_layer.items())}
