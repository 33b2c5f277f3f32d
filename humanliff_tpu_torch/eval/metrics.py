"""Image metrics matching the reference eval harness (recon_NeRF/lib/all_test.py:19-42);
a copy of ``humanliff_tpu/eval/metrics.py`` (numpy only).

- PSNR: ``-10 log10(mean((a-b)^2))`` on float images in [0, 1] (all_test.py:19-21).
- SSIM: reference used skimage's ``compare_ssim`` with its defaults (gaussian off,
  7x7 uniform window, data_range inferred); implemented here directly (skimage is not
  vendored) with the standard uniform-window formulation and data_range=1.
- LPIPS: the reference depends on the torch ``lpips`` VGG checkpoint. ``lpips_fn``
  returns the port's VGG-LPIPS (``eval/lpips.py``) when its weight npz exists,
  else the torch ``lpips`` package's when it is installed, else ``None`` and
  eval reports skip the column. The weights are not in the repository
  (docs/LPIPS_PROBE.md), so ``None`` is what it returns here and on the card.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    m = mse(a, b)
    return float(-10.0 * np.log10(max(m, 1e-12)))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Separable box filter with same-size 'valid'-style edges handled by padding."""
    pad = size // 2
    xp = np.pad(x, [(pad, pad), (pad, pad)] + [(0, 0)] * (x.ndim - 2), mode="symmetric")
    c = np.cumsum(xp, axis=0)
    c = np.concatenate([np.zeros_like(c[:1]), c], axis=0)
    out = (c[size:] - c[:-size]) / size
    c = np.cumsum(out, axis=1)
    c = np.concatenate([np.zeros_like(c[:, :1]), c], axis=1)
    out = (c[:, size:] - c[:, :-size]) / size
    return out


def ssim(
    a: np.ndarray, b: np.ndarray, data_range: float = 1.0, win_size: int = 7
) -> float:
    """Mean SSIM with a uniform window (skimage compare_ssim defaults)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:  # channel-wise mean, matching multichannel=True
        return float(
            np.mean([ssim(a[..., c], b[..., c], data_range, win_size) for c in range(a.shape[-1])])
        )
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2

    mu_a = _uniform_filter(a, win_size)
    mu_b = _uniform_filter(b, win_size)
    # skimage uses unbiased covariances with the same window.
    n = win_size * win_size
    cov_norm = n / (n - 1)
    var_a = cov_norm * (_uniform_filter(a * a, win_size) - mu_a * mu_a)
    var_b = cov_norm * (_uniform_filter(b * b, win_size) - mu_b * mu_b)
    cov = cov_norm * (_uniform_filter(a * b, win_size) - mu_a * mu_b)

    num = (2 * mu_a * mu_b + C1) * (2 * cov + C2)
    den = (mu_a**2 + mu_b**2 + C1) * (var_a + var_b + C2)
    s = num / den
    pad = win_size // 2
    interior = s[pad:-pad, pad:-pad] if s.shape[0] > 2 * pad and s.shape[1] > 2 * pad else s
    return float(interior.mean())


def lpips_fn(device="cuda") -> Optional[Callable[[np.ndarray, np.ndarray], float]]:
    """Perceptual metric of two (H, W, 3) images in [0, 1]: the port's
    VGG-LPIPS on ``device`` when its weight npz exists (the gate is only the
    weights' availability), else the torch ``lpips`` package's, else None."""
    from humanliff_tpu_torch.eval.lpips import make_lpips

    fn = make_lpips(device=device)
    if fn is not None:
        return fn
    try:  # pragma: no cover - environment-dependent
        import lpips  # type: ignore
        import torch

        net = lpips.LPIPS(net="vgg")

        def compute(a: np.ndarray, b: np.ndarray) -> float:
            ta = torch.from_numpy(np.asarray(a, np.float32)).permute(2, 0, 1)[None] * 2 - 1
            tb = torch.from_numpy(np.asarray(b, np.float32)).permute(2, 0, 1)[None] * 2 - 1
            with torch.no_grad():
                return float(net(ta, tb))

        return compute
    except Exception:
        return None
