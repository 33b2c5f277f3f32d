"""Layer-wise progressive generation (port of ``humanliff_tpu/sampling/layered.py``;
reference scripts/triplane_sample_layered.py).

Layer k is generated with class label y = k, conditioned through the ControlNet
branch on layer k-1's sample (zeros for k = 0; layered.py:100-103). Samples are
NHWC ``(B, H, W, 27)`` in [-1, 1]; the UNet sees them as NCHW views, which are
channels_last in memory, so no copy is made. On CUDA the UNet runs under bf16
autocast and the diffusion arithmetic stays fp32.

``use_ddim`` samples by DDIM (eta 0) instead of the ancestral chain, over the
diffusion's respaced steps (``timestep_respacing="ddim50"``).
``generate_layer_progressive`` also records the denoising trajectory.

Not ported yet: ``parallel_window`` (Picard sampling), ``plan_workload`` /
``generate_workload`` (their cost table was measured on a TPU) and the sharded
path.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from humanliff_tpu_torch.diffusion.gaussian import GaussianDiffusion, StepNoise

LAYER_NAMES: List[str] = [
    "person",
    "person_pant",
    "person_pant_shirt",
    "person_pant_shirt_shoes",
]


def planes_image_to_triplane(x: torch.Tensor) -> torch.Tensor:
    """(H, W, 3*C3) NHWC sample -> (3, C3, H, W) renderer planes (plane-major channels)."""
    H, W, C = x.shape
    return x.permute(2, 0, 1).reshape(3, C // 3, H, W)


def triplane_to_planes_image(planes: torch.Tensor) -> torch.Tensor:
    """(3, C3, H, W) -> (H, W, 3*C3) NHWC diffusion image."""
    n, c3, H, W = planes.shape
    return planes.reshape(n * c3, H, W).permute(1, 2, 0)


def _model_fn(model, autocast: bool):
    """NHWC in, fp32 NHWC out: the diffusion loop's view of the NCHW UNet."""
    def fn(x, ts, x_cond, y):
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            out = model(x.permute(0, 3, 1, 2), ts, x_cond.permute(0, 3, 1, 2), y)
        return out.permute(0, 2, 3, 1).float()
    return fn


def _layer_inputs(layer_idx, x_cond, batch_size, image_size, channels, device):
    shape = (batch_size, image_size, image_size, channels)
    x_cond = torch.zeros(shape, device=device) if x_cond is None else x_cond.to(device)
    y = torch.full((batch_size,), layer_idx, dtype=torch.int64, device=device)
    return shape, x_cond, y


@torch.no_grad()
def generate_layer(
    model,
    diffusion: GaussianDiffusion,
    layer_idx: int,
    x_cond: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
    batch_size: int = 1,
    image_size: int = 256,
    channels: int = 27,
    clip_denoised: bool = True,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[StepNoise] = None,
    device="cuda",
    use_ddim: bool = False,
) -> torch.Tensor:
    """Sample one layer: (B, H, W, C) in [-1, 1] by the DDPM ancestral chain,
    or by DDIM with ``use_ddim``.

    ``noise`` / ``step_noise`` inject x_T and the per-step noise (see
    ``GaussianDiffusion.p_sample_loop``); otherwise they come from ``generator``.
    """
    device = torch.device(device)
    shape, x_cond, y = _layer_inputs(layer_idx, x_cond, batch_size, image_size, channels,
                                     device)
    loop = diffusion.ddim_sample_loop if use_ddim else diffusion.p_sample_loop
    return loop(
        _model_fn(model, device.type == "cuda"), shape, generator=generator,
        x_cond=x_cond, noise=noise, step_noise=step_noise,
        clip_denoised=clip_denoised, model_kwargs={"y": y}, device=device,
    )


@torch.no_grad()
def generate_layer_progressive(
    model,
    diffusion: GaussianDiffusion,
    layer_idx: int,
    x_cond: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
    batch_size: int = 1,
    image_size: int = 256,
    channels: int = 27,
    record_every: int = 10,
    use_ddim: bool = False,
    clip_denoised: bool = True,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[StepNoise] = None,
    device="cuda",
) -> Tuple[torch.Tensor, List[Tuple[int, np.ndarray]]]:
    """:func:`generate_layer` that also records the denoising trajectory:
    returns ``(samples, traj)``, ``traj`` a list of ``(t, pred_xstart numpy)``
    every ``record_every`` steps and at t = 0 (the reference's
    ``p_sample_loop_progressive``, gaussian_diffusion.py:445-482). Only the
    recorded steps come to the host.
    """
    device = torch.device(device)
    shape, x_cond, y = _layer_inputs(layer_idx, x_cond, batch_size, image_size, channels,
                                     device)
    loop = (diffusion.ddim_sample_loop_progressive if use_ddim
            else diffusion.p_sample_loop_progressive)
    T = diffusion.num_timesteps
    traj, x = [], None
    for i, out in enumerate(loop(
            _model_fn(model, device.type == "cuda"), shape, generator=generator,
            x_cond=x_cond, noise=noise, step_noise=step_noise,
            clip_denoised=clip_denoised, model_kwargs={"y": y}, device=device)):
        x = out["sample"]
        t = T - 1 - i
        if i % max(record_every, 1) == 0 or t == 0:
            traj.append((t, out["pred_xstart"].float().cpu().numpy()))
    return x, traj


def generate_all_layers(
    model,
    diffusion: GaussianDiffusion,
    generator: Optional[torch.Generator] = None,
    batch_size: int = 1,
    image_size: int = 256,
    channels: int = 27,
    num_layers: int = 4,
    noises: Optional[Sequence[Tuple[torch.Tensor, StepNoise]]] = None,
    device="cuda",
    callback: Optional[Callable[[str, torch.Tensor], None]] = None,
    use_ddim: bool = False,
) -> Dict[str, torch.Tensor]:
    """The progressive chain; returns ``{layer_name: (B, H, W, C)}``.

    ``noises[k] = (x_T, step_noise)`` injects layer k's noise; otherwise it is
    drawn from ``generator``. ``callback(name, samples)`` runs after each layer.
    """
    out: Dict[str, torch.Tensor] = {}
    x_cond = None
    for k in range(num_layers):
        noise, step_noise = noises[k] if noises is not None else (None, None)
        samples = generate_layer(
            model, diffusion, k, x_cond, generator, batch_size, image_size, channels,
            noise=noise, step_noise=step_noise, device=device, use_ddim=use_ddim,
        )
        name = LAYER_NAMES[k] if k < len(LAYER_NAMES) else f"layer_{k}"
        out[name] = samples
        if callback is not None:
            callback(name, samples)
        x_cond = samples
    return out
