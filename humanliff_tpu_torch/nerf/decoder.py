"""The shared NeRF MLP decoder (port of ``humanliff_tpu/nerf/decoder.py``).

Trunk of three softplus layers (27 -> 128 -> 128, skip-concat of the input
before the third), a 1-d alpha head, and a view-conditioned RGB head
(feature 128 + PE(4) of the view direction 27 -> 64 -> 3). Layer names follow
the reference's state dict (``pts_linears.{0,1,2}``, ``alpha_linear``,
``feature_linear``, ``views_linear``, ``rgb_linear``; reference
lib/renderer.py:38-43), so a reference Stage-1 checkpoint loads as it is.

Every forward goes through :func:`humanliff_tpu_torch.ops.fused_decoder.fused_decoder`:
the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from humanliff_tpu_torch.ops.fused_decoder import fused_decoder


class NeRFDecoder(nn.Module):
    def __init__(self, d_in: int = 27, d_hidden: int = 128, view_freqs: int = 4):
        super().__init__()
        if (d_in, d_hidden, view_freqs) != (27, 128, 4):
            raise ValueError("the fused decoder kernel is built for 27 -> 128, PE(4)")
        d_view = 3 * (2 * view_freqs + 1)
        self.pts_linears = nn.ModuleList([
            nn.Linear(d_in, d_hidden),
            nn.Linear(d_hidden, d_hidden),
            nn.Linear(d_hidden + d_in, d_hidden),
        ])
        self.alpha_linear = nn.Linear(d_hidden, 1)
        self.feature_linear = nn.Linear(d_hidden, d_hidden)
        self.views_linear = nn.Linear(d_hidden + d_view, d_hidden // 2)
        self.rgb_linear = nn.Linear(d_hidden // 2, 3)

    def weights(self) -> Tuple[torch.Tensor, ...]:
        """The kernel's flat 14-tuple, in ``torch.nn.Linear`` layout."""
        layers = [*self.pts_linears, self.alpha_linear, self.feature_linear,
                  self.views_linear, self.rgb_linear]
        return tuple(t for lin in layers for t in (lin.weight, lin.bias))

    def forward(
        self, features: torch.Tensor, viewdirs: Optional[torch.Tensor] = None
    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(raw rgb (M, 3) or None, raw density (M, 1)), fp32."""
        return fused_decoder(self.weights(), features, viewdirs)
