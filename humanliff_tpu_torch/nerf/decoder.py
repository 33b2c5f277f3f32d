"""The shared NeRF MLP decoder (port of ``humanliff_tpu/nerf/decoder.py``).

Trunk of three softplus layers (27 -> 128 -> 128, skip-concat of the input
before the third), a 1-d alpha head, and a view-conditioned RGB head
(feature 128 + PE(4) of the view direction 27 -> 64 -> 3). Layer names follow
the reference's state dict (``pts_linears.{0,1,2}``, ``alpha_linear``,
``feature_linear``, ``views_linear``, ``rgb_linear``; reference
lib/renderer.py:38-43), so a reference Stage-1 checkpoint loads as it is.

Every forward goes through :func:`humanliff_tpu_torch.ops.fused_decoder.fused_decoder`:
the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

Training keeps the decoder's 14 tensors in one flat fp32 buffer
(:class:`FlatDecoder`): the kernel's packed-weight cache is keyed on each
weight's storage and version counter, and views share their buffer's
counter, so an in-place optimizer update of the buffer repacks.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from humanliff_tpu_torch.ops.fused_decoder import _SHAPES, fused_decoder

# State-dict names of the kernel's 14 weights, in ``NeRFDecoder.weights()`` order.
PARAM_NAMES = tuple(f"{layer}.{kind}" for layer in (
    "pts_linears.0", "pts_linears.1", "pts_linears.2", "alpha_linear", "feature_linear",
    "views_linear", "rgb_linear") for kind in ("weight", "bias"))
N_PARAMS = sum(math.prod(s) for s in _SHAPES)


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


def weight_views(flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The 14 weights as views of a flat ``(N_PARAMS,)`` buffer."""
    if flat.shape != (N_PARAMS,):
        raise ValueError(f"flat decoder weights must be ({N_PARAMS},), got {tuple(flat.shape)}")
    out, at = [], 0
    for shape in _SHAPES:
        n = math.prod(shape)
        out.append(flat[at:at + n].view(shape))
        at += n
    return tuple(out)


def flatten_state_dict(state_dict: Mapping[str, torch.Tensor], device=None) -> torch.Tensor:
    """A new flat fp32 buffer holding a ``NeRFDecoder`` state dict."""
    missing = set(PARAM_NAMES) ^ set(state_dict)
    if missing:
        raise KeyError(f"not a NeRFDecoder state dict: {sorted(missing)}")
    return torch.cat([torch.as_tensor(state_dict[n]).detach().float().reshape(-1)
                      for n in PARAM_NAMES]).to(device)


class FlatDecoder:
    """The decoder over a flat weight buffer ``flat`` ``(N_PARAMS,)``: called
    like :class:`NeRFDecoder`, its weights are views of ``flat`` made at each
    call, so gradients reach ``flat`` and in-place updates of it are seen."""

    def __init__(self, flat: torch.Tensor):
        self.flat = flat

    def weights(self) -> Tuple[torch.Tensor, ...]:
        return weight_views(self.flat)

    def __call__(self, features: torch.Tensor, viewdirs: Optional[torch.Tensor] = None):
        return fused_decoder(self.weights(), features, viewdirs)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """A ``NeRFDecoder`` state dict (detached views of the buffer)."""
        return dict(zip(PARAM_NAMES, (w.detach() for w in self.weights())))
