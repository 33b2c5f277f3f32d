"""Layered-chain fidelity in tri-plane space (port of the numpy part of
``humanliff_tpu/eval/fidelity.py``: ``plane_fidelity`` and
``chain_fidelity_report``).

Layer k of the chain should extend its conditioning layer k-1: new garment
content in a localized change region, everything outside it preserved
(triplane_sample_layered.py:124-151). The change region is the set of texels
whose max-channel |difference| exceeds ``threshold``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


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
