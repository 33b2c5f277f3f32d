"""Attention blocks of the UNet (port of ``humanliff_tpu/models/attention.py``):
spatial self-attention (reference unet.py:222-274) and the LDM-style spatial
transformer of ``cond_type="cross_attention"`` (reference
spatial_transformer.py).

Self-attention: the qkv projection's 3C outputs are split as [q | k | v], and
each C-wide part as (heads, head_dim), as in the JAX block.
``F.scaled_dot_product_attention`` computes softmax(q k^T / sqrt(d)) v, the
JAX 1/sqrt(sqrt(d)) on both q and k.

Spatial transformer: the module names are LDM's (``proj_in``,
``transformer_blocks.N.{attn1, attn2, ff, norm1, norm2, norm3}``,
``to_q``/``to_k``/``to_v``/``to_out.0``), with ``proj_in`` a Linear (the JAX
package's Dense) where LDM has a 1x1 conv. The cross-attention product runs
its softmax in fp32 under autocast, as the JAX block does (attention.py:66),
and the feed-forward's GELU is the tanh approximation, flax's ``nn.gelu``
default; LayerNorm eps is flax's 1e-6.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from humanliff_tpu_torch.models.nn import GroupNorm32, zero_module

LAYERNORM_EPS = 1e-6  # flax nn.LayerNorm's default


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


class CrossAttention(nn.Module):
    """Multi-head attention of ``x`` (B, T, query_dim) over ``context``
    (B, S, context_dim), or over ``x`` itself when no context is given."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        B, T, _ = x.shape

        def heads(t):  # (B, L, inner) -> (B, heads, L, dim_head)
            return t.reshape(B, t.shape[1], self.heads, self.dim_head).transpose(1, 2)

        q = heads(self.to_q(x)) * self.dim_head ** -0.5
        k, v = heads(self.to_k(context)), heads(self.to_v(context))
        w = torch.matmul(q, k.transpose(-1, -2))
        w = w.float().softmax(dim=-1).to(v.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(B, T, -1)
        return self.to_out(out)


class GEGLU(nn.Module):
    """``a * gelu(gate)`` of one projection split in halves [a | gate]."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="tanh")


class BasicTransformerBlock(nn.Module):
    """Pre-norm self-attention, cross-attention and GEGLU feed-forward, each
    residual."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head)
        self.ff = nn.Sequential(GEGLU(dim, 4 * dim), nn.Dropout(0.0), nn.Linear(4 * dim, dim))
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.norm1 = nn.LayerNorm(dim, eps=LAYERNORM_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LAYERNORM_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LAYERNORM_EPS)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm, project the H*W positions of an NCHW map to tokens, run
    ``depth`` transformer blocks over them with the optional context, project
    back through a zero-initialised Linear, add to the input."""

    def __init__(self, channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(channels)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, n_heads, d_head, context_dim) for _ in range(depth)])
        self.proj_out = zero_module(nn.Linear(inner, channels))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).reshape(B, C, H * W).transpose(1, 2)  # (B, HW, C)
        h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = self.proj_out(h)
        return x + h.transpose(1, 2).reshape(B, C, H, W)
