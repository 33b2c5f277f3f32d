"""Timestep respacing (port of ``humanliff_tpu/diffusion/respace.py``;
reference improved_diffusion/respace.py).

``space_timesteps`` picks the retained original steps; the respaced
``GaussianDiffusion`` carries ``timestep_map`` and feeds the model the
original step index (rescaled to [0, 1000)).
"""

from __future__ import annotations

from typing import Collection, Union

import numpy as np

from humanliff_tpu_torch.diffusion.gaussian import (
    GaussianDiffusion,
    LossType,
    ModelMeanType,
    ModelVarType,
)
from humanliff_tpu_torch.diffusion.schedules import get_named_beta_schedule


def space_timesteps(num_timesteps: int, section_counts: Union[str, Collection[int]]):
    """The set of original steps to keep: ``"ddimN"`` or per-section counts ``"a,b,c"``."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            want = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                kept = range(0, num_timesteps, stride)
                if len(kept) == want:
                    return set(kept)
            raise ValueError(
                f"no integer stride over {num_timesteps} timesteps keeps exactly {want} DDIM steps"
            )
        section_counts = [int(x) for x in section_counts.split(",")]

    base, extra = divmod(num_timesteps, len(section_counts))
    kept_steps: set = set()
    start = 0
    for i, count in enumerate(section_counts):
        size = base + (1 if i < extra else 0)
        if count > size:
            raise ValueError(f"section {i} spans only {size} timesteps; cannot keep {count}")
        stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        # Accumulate like the reference: j * stride rounds differently at .5.
        pos = 0.0
        for _ in range(count):
            kept_steps.add(start + round(pos))
            pos += stride
        start += size
    return kept_steps


def spaced_diffusion(
    *,
    betas: np.ndarray,
    use_timesteps: Collection[int],
    model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
    model_var_type: ModelVarType = ModelVarType.FIXED_LARGE,
    loss_type: LossType = LossType.MSE,
    rescale_timesteps: bool = True,
) -> GaussianDiffusion:
    """A GaussianDiffusion over the retained subset (respace.py:63-107)."""
    use_timesteps = set(use_timesteps)
    alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, np.float64))
    last = 1.0
    new_betas, timestep_map = [], []
    for i, ac in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - ac / last)
            last = ac
            timestep_map.append(i)
    return GaussianDiffusion(
        betas=np.array(new_betas, np.float64),
        model_mean_type=model_mean_type,
        model_var_type=model_var_type,
        loss_type=loss_type,
        rescale_timesteps=rescale_timesteps,
        timestep_map=np.array(timestep_map, np.int64),
        original_num_steps=len(betas),
    )


def create_diffusion(
    *,
    steps: int = 1000,
    learn_sigma: bool = False,
    sigma_small: bool = False,
    noise_schedule: str = "linear",
    use_kl: bool = False,
    predict_xstart: bool = False,
    rescale_timesteps: bool = True,
    rescale_learned_sigmas: bool = True,
    timestep_respacing: str = "",
) -> GaussianDiffusion:
    """Factory mirroring script_util.create_gaussian_diffusion (script_util.py:260-298)."""
    betas = get_named_beta_schedule(noise_schedule, steps)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    if learn_sigma:
        var_type = ModelVarType.LEARNED_RANGE
    else:
        var_type = ModelVarType.FIXED_SMALL if sigma_small else ModelVarType.FIXED_LARGE
    return spaced_diffusion(
        betas=betas,
        use_timesteps=space_timesteps(steps, timestep_respacing or str(steps)),
        model_mean_type=ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON,
        model_var_type=var_type,
        loss_type=loss_type,
        rescale_timesteps=rescale_timesteps,
    )
