"""LPIPS perceptual distance in PyTorch (port of ``humanliff_tpu/eval/lpips_jax.py``;
reference recon_NeRF/lib/all_test.py:14,37-40, which scores eval renders with
the torch ``lpips`` package, net='vgg').

The metric (Zhang et al. 2018, v0.1 weights): scale the [-1, 1] inputs by the
fixed ImageNet shift/scale, run VGG16 conv features, take the five ReLU slices
(relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), unit-normalize each along
channels, square the difference, collapse channels with the learned
non-negative 1x1 "lin" weights, average spatially, and sum over the slices.

Weights are the plain ``.npz`` of ``compat/lpips_import.py`` (the JAX
package's schema: HWIO ``conv{i}_w``, ``conv{i}_b``, ``lin{l}``), found
through ``HL_LPIPS_WEIGHTS`` or ``assets/lpips_vgg.npz``; they are not in the
repository, so :func:`make_lpips` returns ``None`` until they are. The module
takes the architecture (``cfg``, ``slices``) as parameters, so a tiny pyramid
and the full VGG16 run the same code.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 feature config: conv output channels, 'M' = 2x2 max pool.
VGG16_CFG: Sequence = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                       512, 512, 512, "M", 512, 512, 512)
# Indices (counting conv layers only) after which a feature slice is taken:
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3.
VGG16_SLICES = (2, 4, 7, 10, 13)

# lpips v0.1 input scaling layer constants (ScalingLayer in lpips/lpips.py).
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Channel-wise unit normalization (lpips ``normalize_tensor``), NCHW."""
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """LPIPS over NCHW RGB images in [-1, 1]; ``forward(a, b)`` -> (N,) distances.

    ``convs[i]`` is conv layer i (3x3, padding 1, the JAX package's SAME);
    ``lin{l}`` the channel weights of slice l.
    """

    def __init__(self, cfg: Sequence = VGG16_CFG, slices: Sequence[int] = VGG16_SLICES):
        super().__init__()
        self.cfg, self.slices = tuple(cfg), tuple(slices)
        convs, chans, cin = [], [], 3
        for c in self.cfg:
            if c == "M":
                continue
            convs.append(nn.Conv2d(cin, c, 3, padding=1))
            chans.append(c)
            cin = c
        self.convs = nn.ModuleList(convs)
        for li, sl in enumerate(self.slices):
            self.register_buffer(f"lin{li}", torch.zeros(chans[sl - 1]))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The conv tower on NCHW input; the slices after their ReLU."""
        feats, conv_i = [], 0
        for c in self.cfg:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)  # floor semantics, as the JAX crop + VALID window
                continue
            x = F.relu(self.convs[conv_i](x))
            conv_i += 1
            if conv_i in self.slices:
                feats.append(x)
        return feats

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = self.features((a - self.shift) / self.scale)
        fb = self.features((b - self.shift) / self.scale)
        total = 0.0
        for li, (xa, xb) in enumerate(zip(fa, fb)):
            d = (_unit_normalize(xa) - _unit_normalize(xb)) ** 2
            w = getattr(self, f"lin{li}").view(1, -1, 1, 1)
            total = total + (d * w).sum(dim=1).mean(dim=(1, 2))
        return total

    def load_npz_params(self, params: Dict[str, np.ndarray]) -> "LPIPS":
        """Load the npz schema: HWIO ``conv{i}_w`` (transposed to OIHW),
        ``conv{i}_b``, ``lin{l}``."""
        with torch.no_grad():
            for i, conv in enumerate(self.convs):
                w = np.asarray(params[f"conv{i}_w"], np.float32)
                conv.weight.copy_(torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()))
                conv.bias.copy_(torch.from_numpy(np.asarray(params[f"conv{i}_b"], np.float32)))
            for li in range(len(self.slices)):
                getattr(self, f"lin{li}").copy_(
                    torch.from_numpy(np.asarray(params[f"lin{li}"], np.float32)))
        return self


_WEIGHT_CACHE: Dict[str, Dict[str, np.ndarray]] = {}


def load_weights(path: str) -> Dict[str, np.ndarray]:
    """The npz written by ``compat/lpips_import.py`` as numpy arrays (cached
    per path: eval loops ask for the metric per subject and layer)."""
    cached = _WEIGHT_CACHE.get(path)
    if cached is None:
        with np.load(path) as raw:
            cached = {k: raw[k] for k in raw.files}
        _WEIGHT_CACHE[path] = cached
    return cached


def default_weights_path() -> Optional[str]:
    p = os.environ.get("HL_LPIPS_WEIGHTS")
    if p and os.path.exists(p):
        return p
    here = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "lpips_vgg.npz")
    return os.path.abspath(here) if os.path.exists(here) else None


def make_lpips(path: Optional[str] = None, device="cuda"):
    """``fn(a_hwc01, b_hwc01) -> float`` on ``device``, or None when no
    weights exist. Inputs are float images in [0, 1] (the eval harness
    convention), mapped to [-1, 1]."""
    path = path or default_weights_path()
    if path is None:
        return None
    device = torch.device(device)
    net = LPIPS().load_npz_params(load_weights(path)).to(device).eval()

    def compute(a: np.ndarray, b: np.ndarray) -> float:
        def t(x):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
            return x.permute(2, 0, 1)[None] * 2.0 - 1.0

        with torch.no_grad():
            return float(net(t(a), t(b))[0])

    return compute
