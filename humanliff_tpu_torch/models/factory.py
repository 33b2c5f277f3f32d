"""Model and diffusion factory (port of ``humanliff_tpu/models/factory.py``;
reference improved_diffusion/script_util.py): the channel-mult table, the
attention-resolution parsing and the AdaGN-mode NUM_CLASSES=1000 quirk
(script_util.py:130-133)."""

from __future__ import annotations

from typing import Optional, Tuple

from humanliff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from humanliff_tpu_torch.diffusion.respace import create_diffusion
from humanliff_tpu_torch.models.unet import UNetModel


def model_and_diffusion_defaults() -> dict:
    """HumanLiff's flagship settings (triplane_scripts/*.sh)."""
    return dict(
        image_size=256,
        in_channels=27,
        num_channels=192,
        out_channels=27,
        num_res_blocks=3,
        num_heads=4,
        num_heads_upsample=-1,
        attention_resolutions="32,16,8",
        dropout=0.0,
        learn_sigma=False,
        sigma_small=False,
        class_cond=True,
        diffusion_steps=1000,
        noise_schedule="linear",
        timestep_respacing="",
        use_kl=False,
        predict_xstart=False,
        rescale_timesteps=True,
        rescale_learned_sigmas=True,
        use_scale_shift_norm=True,
        cond_type="controlnet",
        use_3d_aware=False,
        use_checkpoint=False,
    )


def channel_mult_for(image_size: int) -> Tuple[int, ...]:
    if image_size in (256, 128, 192, 224):
        return (1, 1, 2, 2, 4, 4)
    if image_size == 64:
        return (1, 2, 3, 4)
    if image_size == 32:
        return (1, 2, 2, 2)
    if image_size == 16:  # tiny smoke-test configs
        return (1, 2)
    raise ValueError(f"unsupported image size: {image_size}")


def create_model(
    image_size: int,
    in_channels: int,
    num_channels: int,
    out_channels: int,
    num_res_blocks: int,
    learn_sigma: bool,
    class_cond: bool,
    attention_resolutions: str,
    num_heads: int,
    num_heads_upsample: int,
    use_scale_shift_norm: bool,
    cond_type: str,
    dropout: float,
    channel_mult: Optional[Tuple[int, ...]] = None,
    use_3d_aware: bool = False,
    use_checkpoint: bool = False,
) -> UNetModel:
    if channel_mult is None:
        channel_mult = channel_mult_for(image_size)
    attention_ds = tuple(image_size // int(r) for r in attention_resolutions.split(","))
    # The reference's AdaGN-mode NUM_CLASSES=1000 quirk (script_util.py:130-133).
    num_classes = 1000 if cond_type == "AdaGN" and not use_3d_aware else 4
    return UNetModel(
        in_channels=in_channels,
        model_channels=num_channels,
        out_channels=out_channels if not learn_sigma else out_channels * 2,
        num_res_blocks=num_res_blocks,
        attention_resolutions=attention_ds,
        dropout=dropout,
        channel_mult=channel_mult,
        num_classes=num_classes if class_cond else None,  # 4: the four clothing layers
        num_heads=num_heads,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        cond_type=cond_type,
        use_3d_aware=use_3d_aware,
        use_checkpoint=use_checkpoint,
        image_size=image_size,
    )


def create_model_and_diffusion(**kwargs) -> Tuple[UNetModel, GaussianDiffusion]:
    cfg = model_and_diffusion_defaults()
    cfg.update(kwargs)
    model = create_model(
        image_size=cfg["image_size"],
        in_channels=cfg["in_channels"],
        num_channels=cfg["num_channels"],
        out_channels=cfg["out_channels"],
        num_res_blocks=cfg["num_res_blocks"],
        learn_sigma=cfg["learn_sigma"],
        class_cond=cfg["class_cond"],
        attention_resolutions=cfg["attention_resolutions"],
        num_heads=cfg["num_heads"],
        num_heads_upsample=cfg["num_heads_upsample"],
        use_scale_shift_norm=cfg["use_scale_shift_norm"],
        cond_type=cfg["cond_type"],
        dropout=cfg["dropout"],
        use_3d_aware=cfg["use_3d_aware"],
        use_checkpoint=cfg["use_checkpoint"],
    )
    diffusion = create_diffusion(
        steps=cfg["diffusion_steps"],
        learn_sigma=cfg["learn_sigma"],
        sigma_small=cfg["sigma_small"],
        noise_schedule=cfg["noise_schedule"],
        use_kl=cfg["use_kl"],
        predict_xstart=cfg["predict_xstart"],
        rescale_timesteps=cfg["rescale_timesteps"],
        rescale_learned_sigmas=cfg["rescale_learned_sigmas"],
        timestep_respacing=cfg["timestep_respacing"],
    )
    return model, diffusion
