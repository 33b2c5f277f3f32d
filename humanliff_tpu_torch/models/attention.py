"""Spatial self-attention (port of ``humanliff_tpu/models/attention.py::SelfAttentionBlock``;
reference unet.py:222-274).

The qkv projection's 3C outputs are split as [q | k | v], and each C-wide part
as (heads, head_dim), as in the JAX block. ``F.scaled_dot_product_attention``
computes softmax(q k^T / sqrt(d)) v, the JAX 1/sqrt(sqrt(d)) on both q and k.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from humanliff_tpu_torch.models.nn import GroupNorm32, zero_module


class AttentionBlock(nn.Module):
    """Residual QKV self-attention over the H*W positions of an NCHW map."""

    def __init__(self, channels: int, num_heads: int = 1):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = zero_module(nn.Conv1d(channels, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        T = H * W
        h = x.reshape(B, C, T)
        q, k, v = self.qkv(self.norm(h)).chunk(3, dim=1)  # each (B, C, T)
        hd = C // self.num_heads

        def heads(t):
            return t.reshape(B, self.num_heads, hd, T).transpose(2, 3)  # (B, nh, T, hd)

        out = F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
        out = self.proj_out(out.transpose(2, 3).reshape(B, C, T))
        return (h + out).reshape(B, C, H, W)
