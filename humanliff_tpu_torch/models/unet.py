"""The improved-diffusion UNet with HumanLiff's ControlNet layer conditioning.

Port of ``humanliff_tpu/models/unet.py`` (``cond_type="controlnet"``, the
flagship) in NCHW, the reference layout; on CUDA the caller runs it
channels_last under bf16 autocast. Module names follow the reference state
dict (``time_embed``, ``label_emb``, ``input_blocks``, ``middle_block``,
``output_blocks``, ``out``, ``input_blocks_cond``, ``input_blocks_proj_cond``),
so reference checkpoints load as they are and the JAX package's
``unet_params_from_state_dict`` maps a port state dict to flax parameters.

ControlNet (reference unet.py:477-518, :594-609): a copy of the encoder runs on
``x + x_cond``; every block's output passes a zero-init 1x1 projection, which
is both added to the matching decoder skip and fed to the next copy block
(the projected features flow forward, a reference quirk kept for parity).
The concat, AdaGN and cross-attention modes, 3D-aware mixing and the
super-resolution wrapper are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from humanliff_tpu_torch.models.attention import AttentionBlock
from humanliff_tpu_torch.models.nn import GroupNorm32, timestep_embedding, zero_module


class ResBlock(nn.Module):
    """GroupNorm-SiLU-conv twice, with the time embedding as FiLM (scale-shift)
    or as an added bias, and a 1x1 skip conv when the width changes."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_scale_shift_norm: bool = True, dropout: float = 0.0):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(),
            nn.Conv2d(channels, out_channels, 3, padding=1),
        )
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            nn.Linear(emb_channels,
                      2 * out_channels if use_scale_shift_norm else out_channels),
        )
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(p=dropout),
            zero_module(nn.Conv2d(out_channels, out_channels, 3, padding=1)),
        )
        self.skip_connection = (
            nn.Identity() if channels == out_channels
            else nn.Conv2d(channels, out_channels, 1)
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x)
        emb_out = self.emb_layers(emb).to(h.dtype)[..., None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_layers[0](h) * (1 + scale) + shift
            h = self.out_layers[1:](h)
        else:
            h = self.out_layers(h + emb_out)
        return self.skip_connection(x) + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv (the reference's conv_resample=True, its only setting)."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class TimestepEmbedSequential(nn.Sequential):
    """A block of layers; ResBlocks also take the time embedding."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class UNetModel(nn.Module):
    def __init__(
        self,
        in_channels: int = 27,
        model_channels: int = 192,
        out_channels: int = 27,
        num_res_blocks: int = 3,
        attention_resolutions: Sequence[int] = (8, 16, 32),  # downsample rates
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
        num_classes: Optional[int] = None,
        num_heads: int = 4,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = True,
        cond_type: str = "controlnet",
    ):
        super().__init__()
        if cond_type != "controlnet":
            raise NotImplementedError(f"cond_type={cond_type!r} is not ported yet")
        self.model_channels = model_channels
        self.num_classes = num_classes
        self._cfg = dict(
            num_res_blocks=num_res_blocks, attention_resolutions=tuple(attention_resolutions),
            dropout=dropout, channel_mult=tuple(channel_mult), num_heads=num_heads, use_scale_shift_norm=use_scale_shift_norm,
            in_channels=in_channels,
        )
        ted = model_channels * 4
        self.time_embed = nn.Sequential(
            nn.Linear(model_channels, ted), nn.SiLU(), nn.Linear(ted, ted)
        )
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)

        self.input_blocks, chans = self._encoder()
        ch = chans[-1]
        res = dict(emb_channels=ted, use_scale_shift_norm=use_scale_shift_norm,
                   dropout=dropout)
        self.middle_block = TimestepEmbedSequential(
            ResBlock(ch, out_channels=ch, **res),
            AttentionBlock(ch, num_heads),
            ResBlock(ch, out_channels=ch, **res),
        )

        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        self.output_blocks = nn.ModuleList()
        ds = 2 ** (len(channel_mult) - 1)
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                out_ch = model_channels * mult
                layers: List[nn.Module] = [
                    ResBlock(ch + chans.pop(), out_channels=out_ch, **res)
                ]
                ch = out_ch
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, heads_up))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))

        self.out = nn.Sequential(
            GroupNorm32(ch), nn.SiLU(),
            zero_module(nn.Conv2d(ch, out_channels, 3, padding=1)),
        )

        self.input_blocks_cond, cond_chans = self._encoder()
        self.input_blocks_proj_cond = nn.ModuleList(
            [zero_module(nn.Conv2d(c, c, 1)) for c in cond_chans]
        )

    def _encoder(self) -> Tuple[nn.ModuleList, List[int]]:
        """The encoder's blocks and each block's output width (unet.py:375-420)."""
        c = self._cfg
        mc = self.model_channels
        res = dict(emb_channels=4 * mc, use_scale_shift_norm=c["use_scale_shift_norm"],
                   dropout=c["dropout"])
        blocks = nn.ModuleList([
            TimestepEmbedSequential(nn.Conv2d(c["in_channels"], mc, 3, padding=1))
        ])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(c["channel_mult"]):
            for _ in range(c["num_res_blocks"]):
                layers: List[nn.Module] = [ResBlock(ch, out_channels=mult * mc, **res)]
                ch = mult * mc
                if ds in c["attention_resolutions"]:
                    layers.append(AttentionBlock(ch, c["num_heads"]))
                blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != len(c["channel_mult"]) - 1:
                blocks.append(TimestepEmbedSequential(Downsample(ch)))
                chans.append(ch)
                ds *= 2
        return blocks, chans

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        x_cond: torch.Tensor,
        y: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x, x_cond: (B, C, H, W); timesteps (B,), possibly fractional; y (B,) labels."""
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        if self.num_classes is not None:
            emb = emb + self.label_emb(y)

        hs = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)

        hs_cond = []
        hc = x + x_cond
        for block, proj in zip(self.input_blocks_cond, self.input_blocks_proj_cond):
            hc = proj(block(hc, emb))
            hs_cond.append(hc)

        for block in self.output_blocks:
            skip = hs.pop() + hs_cond.pop()
            h = block(torch.cat([h, skip], dim=1), emb)
        return self.out(h)
