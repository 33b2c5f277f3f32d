"""The improved-diffusion UNet with HumanLiff's layer conditioning (port of
``humanliff_tpu/models/unet.py``), in NCHW, the reference layout; on CUDA the
caller runs it channels_last under bf16 autocast. Module names follow the
reference state dict (``time_embed``, ``label_emb``, ``input_blocks``,
``middle_block``, ``output_blocks``, ``out``, ``input_blocks_cond``,
``input_blocks_proj_cond``), so the JAX package's
``unet_params_from_state_dict`` maps a port state dict of the ControlNet
modes to flax parameters.

Conditioning modes (``cond_type``):

- ``controlnet`` (the flagship, reference unet.py:477-518, :594-609): a copy
  of the encoder runs on ``x + x_cond``; every block's output passes a
  zero-init 1x1 projection, which is both added to the matching decoder skip
  and fed to the next copy block (the projected features flow forward, a
  reference quirk kept for parity). The copy uses plain self-attention and no
  3D-aware mixing (unet.py:491-508).
- ``concat``: x_cond joins x on channels at the input, so the first conv
  takes ``2 * in_channels`` (x_cond has x's channels).
- ``AdaGN``: ``cond_conv1`` (6 channels, stride 2) -> ``cond_conv2`` (1
  channel, stride 2) -> flatten -> ``cond_linear`` to the time embedding's
  width, added to the time embedding.
- ``cross_attention``: the same three layers make one context token
  (B, 1, 4 * model_channels) for ``SpatialTransformer`` blocks in every
  attention slot, ``transformer_depth`` blocks each.
- ``""``: no conditioning; x_cond is ignored.

``cond_linear`` reads the flattened map of ``cond_conv2``, whose size follows
the image: AdaGN and cross-attention need ``image_size``. These three layers'
names are the JAX module tree's and are not yet checked against a reference
checkpoint (ROADMAP A14).

``use_3d_aware`` (unet.py:208-213, :566-570, :613-614): the three plane
groups of the channels roll out side by side along the width, each ResBlock
of the main path exchanges per-plane means before its output conv (which
then reads 3x its channels), and the output folds the width thirds back
into channels. CONSTRUCTOR-UNIT NOTE, as in the JAX package: the reference
passes in/out channels already divided by 3 in this mode; this class takes
the full plane channel count and divides internally, so a reference 3D-aware
checkpoint (built with C//3 units) loads into a model built with C units
(tests/test_3d_aware_parity.py checks the shapes on the JAX side).

``use_checkpoint`` recomputes each encoder, middle and decoder block's
activations in the backward (``torch.utils.checkpoint``, non-reentrant), as
JAX rematerialises each ``UNetBlock``; it acts only where autograd records.

``SuperResModel`` (unet.py:651-671) upsamples a low-resolution image
bilinearly to x's size and joins it to x on channels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from humanliff_tpu_torch.models.attention import AttentionBlock, SpatialTransformer
from humanliff_tpu_torch.models.nn import GroupNorm32, timestep_embedding, zero_module

COND_TYPES = ("", "controlnet", "concat", "AdaGN", "cross_attention")


def unroll_planes(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C/3, H, 3W): the channel thirds side by side."""
    return torch.cat(x.chunk(3, dim=1), dim=3)


def fold_planes(h: torch.Tensor) -> torch.Tensor:
    """(B, C, H, 3W) -> (B, 3C, H, W): the width thirds stacked on channels."""
    return torch.cat(h.chunk(3, dim=3), dim=1)


def mix_3d_aware(h: torch.Tensor) -> torch.Tensor:
    """Tri-plane mean exchange on the unrolled layout (unet.py:208-213):
    (B, C, H, 3w) -> (B, 3C, H, 3w). Each plane group is joined on channels
    by the other two groups' means over width or height, tiled back."""
    g0, g1, g2 = h.chunk(3, dim=3)

    def wmean(g):
        return g.mean(dim=3, keepdim=True).expand_as(g)

    def hmean(g):
        return g.mean(dim=2, keepdim=True).expand_as(g)

    h_xy = torch.cat([g0, wmean(g1), hmean(g2)], dim=1)
    h_xz = torch.cat([g1, wmean(g0), wmean(g2)], dim=1)
    h_zy = torch.cat([g2, hmean(g0), hmean(g1)], dim=1)
    return torch.cat([h_xy, h_xz, h_zy], dim=3)


def _strided_size(n: int) -> int:
    """A 3x3 stride-2 conv's output size with padding 1."""
    return (n + 1) // 2


class ResBlock(nn.Module):
    """GroupNorm-SiLU-conv twice, with the time embedding as FiLM (scale-shift)
    or as an added bias, and a 1x1 skip conv when the width changes. With
    ``use_3d_aware`` the output conv reads the mean exchange's 3x channels."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_scale_shift_norm: bool = True, dropout: float = 0.0,
                 use_3d_aware: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.use_3d_aware = use_3d_aware
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(),
            nn.Conv2d(channels, out_channels, 3, padding=1),
        )
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            nn.Linear(emb_channels,
                      2 * out_channels if use_scale_shift_norm else out_channels),
        )
        conv_in = 3 * out_channels if use_3d_aware else out_channels
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(p=dropout),
            zero_module(nn.Conv2d(conv_in, out_channels, 3, padding=1)),
        )
        self.skip_connection = (
            nn.Identity() if channels == out_channels
            else nn.Conv2d(channels, out_channels, 1)
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        norm, silu, dropout, conv = self.out_layers
        h = self.in_layers(x)
        emb_out = self.emb_layers(emb).to(h.dtype)[..., None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = norm(h) * (1 + scale) + shift
            if self.use_3d_aware:
                h = mix_3d_aware(h)
            h = silu(h)
        else:
            h = silu(norm(h + emb_out))
            if self.use_3d_aware:
                h = mix_3d_aware(h)
        return self.skip_connection(x) + conv(dropout(h))


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
    """A block of layers; ResBlocks also take the time embedding and spatial
    transformers the context."""

    def forward(self, x, emb, context=None):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
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
        use_3d_aware: bool = False,
        transformer_depth: int = 1,
        use_checkpoint: bool = False,
        image_size: Optional[int] = None,
    ):
        super().__init__()
        if cond_type not in COND_TYPES:
            raise ValueError(f"unknown cond_type {cond_type!r}; one of {COND_TYPES}")
        if use_3d_aware and (in_channels % 3 or out_channels % 3):
            raise ValueError("use_3d_aware needs in and out channels divisible by 3 "
                             f"(three plane groups), got {in_channels} and {out_channels}")
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.cond_type = cond_type
        self.use_3d_aware = use_3d_aware
        self.use_checkpoint = use_checkpoint
        self._cfg = dict(
            num_res_blocks=num_res_blocks, attention_resolutions=tuple(attention_resolutions),
            dropout=dropout, channel_mult=tuple(channel_mult), num_heads=num_heads,
            use_scale_shift_norm=use_scale_shift_norm, transformer_depth=transformer_depth,
        )
        ted = model_channels * 4
        self.time_embed = nn.Sequential(
            nn.Linear(model_channels, ted), nn.SiLU(), nn.Linear(ted, ted)
        )
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)

        # Channels the first conv reads: a plane group's on the unrolled layout.
        groups = 3 if use_3d_aware else 1
        x_ch = in_channels // groups
        first_ch = 2 * x_ch if cond_type == "concat" else x_ch

        self.input_blocks, chans = self._encoder(first_ch, cond_copy=False)
        ch = chans[-1]
        res = dict(emb_channels=ted, use_scale_shift_norm=use_scale_shift_norm,
                   dropout=dropout, use_3d_aware=use_3d_aware)
        self.middle_block = TimestepEmbedSequential(
            ResBlock(ch, out_channels=ch, **res),
            self._attention(ch, num_heads),
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
                    layers.append(self._attention(ch, heads_up))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))

        self.out = nn.Sequential(
            GroupNorm32(ch), nn.SiLU(),
            zero_module(nn.Conv2d(ch, out_channels // groups, 3, padding=1)),
        )

        if cond_type == "controlnet":
            self.input_blocks_cond, cond_chans = self._encoder(x_ch, cond_copy=True)
            self.input_blocks_proj_cond = nn.ModuleList(
                [zero_module(nn.Conv2d(c, c, 1)) for c in cond_chans]
            )
        elif cond_type in ("AdaGN", "cross_attention"):
            if image_size is None:
                raise ValueError(f"cond_type={cond_type!r} needs image_size (cond_linear "
                                 "reads the strided condition map)")
            h = _strided_size(_strided_size(image_size))
            w = _strided_size(_strided_size(image_size * groups))
            self.cond_conv1 = nn.Conv2d(x_ch, 6, 3, stride=2, padding=1)
            self.cond_conv2 = nn.Conv2d(6, 1, 3, stride=2, padding=1)
            self.cond_linear = nn.Linear(h * w, ted)

    def _attention(self, ch: int, heads: int) -> nn.Module:
        if self.cond_type == "cross_attention":
            return SpatialTransformer(ch, heads, ch // heads, self._cfg["transformer_depth"],
                                      context_dim=4 * self.model_channels)
        return AttentionBlock(ch, heads)

    def _encoder(self, in_ch: int, cond_copy: bool) -> Tuple[nn.ModuleList, List[int]]:
        """The encoder's blocks and each block's output width (unet.py:375-420).
        The ControlNet copy (``cond_copy``) has plain self-attention and no
        3D-aware mixing."""
        c = self._cfg
        mc = self.model_channels
        res = dict(emb_channels=4 * mc, use_scale_shift_norm=c["use_scale_shift_norm"],
                   dropout=c["dropout"], use_3d_aware=self.use_3d_aware and not cond_copy)
        blocks = nn.ModuleList([TimestepEmbedSequential(nn.Conv2d(in_ch, mc, 3, padding=1))])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(c["channel_mult"]):
            for _ in range(c["num_res_blocks"]):
                layers: List[nn.Module] = [ResBlock(ch, out_channels=mult * mc, **res)]
                ch = mult * mc
                if ds in c["attention_resolutions"]:
                    layers.append(AttentionBlock(ch, c["num_heads"]) if cond_copy
                                  else self._attention(ch, c["num_heads"]))
                blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != len(c["channel_mult"]) - 1:
                blocks.append(TimestepEmbedSequential(Downsample(ch)))
                chans.append(ch)
                ds *= 2
        return blocks, chans

    def _run(self, block: nn.Module, *args) -> torch.Tensor:
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        x_cond: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x, x_cond: (B, C, H, W); timesteps (B,), possibly fractional; y (B,)
        labels. x_cond is required by controlnet and concat, optional for
        AdaGN and cross-attention (as in JAX, no condition is then added) and
        ignored by ``""``."""
        if x_cond is None and self.cond_type in ("controlnet", "concat"):
            raise ValueError(f"cond_type={self.cond_type!r} needs x_cond")
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        if self.use_3d_aware:
            x = unroll_planes(x)
            x_cond = None if x_cond is None else unroll_planes(x_cond)

        context = None
        if self.cond_type == "concat":
            x_in = torch.cat([x, x_cond], dim=1)
        else:
            x_in = x
        if self.cond_type in ("AdaGN", "cross_attention") and x_cond is not None:
            c = self.cond_linear(self.cond_conv2(self.cond_conv1(x_cond)).flatten(1))
            if self.cond_type == "AdaGN":
                emb = emb + c
            else:
                context = c[:, None, :]
        if self.num_classes is not None:
            emb = emb + self.label_emb(y)

        hs = []
        h = x_in
        for block in self.input_blocks:
            h = self._run(block, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)

        if self.cond_type == "controlnet":
            hc = x + x_cond
            for i, (block, proj) in enumerate(zip(self.input_blocks_cond,
                                                  self.input_blocks_proj_cond)):
                hc = proj(self._run(block, hc, emb))
                hs[i] = hs[i] + hc
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=1), emb, context)
        h = self.out(h)
        return fold_planes(h) if self.use_3d_aware else h


class SuperResModel(UNetModel):
    """A UNet conditioned on a low-resolution image (unet.py:651-671), as the
    reference subclasses it, so its state dict has the UNet's names.
    ``in_channels`` counts x and the upsampled image together (twice the
    image's channels), as the JAX ``build_sr_model`` builds the wrapped UNet.

    The upsampling is ``jax.image.resize(..., "bilinear")``'s: half-pixel
    centres without antialiasing, which for upsampling is
    ``F.interpolate(mode="bilinear", align_corners=False)``
    (tests/test_torch_unet_modes.py holds the two together, edges included).
    """

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                low_res: Optional[torch.Tensor] = None, x_cond: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        up = upsample_bilinear(low_res, x.shape[-2:])
        return super().forward(torch.cat([x, up.to(x.dtype)], dim=1), timesteps, x_cond, y)


def upsample_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, *size), bilinear with half-pixel centres."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)
