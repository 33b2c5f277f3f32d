"""Layer-wise progressive generation (port of ``humanliff_tpu/sampling/layered.py``;
reference scripts/triplane_sample_layered.py).

Layer k is generated with class label y = k, conditioned through the ControlNet
branch on layer k-1's sample (zeros for k = 0; layered.py:100-103). Samples are
NHWC ``(B, H, W, 27)`` in [-1, 1]; the UNet sees them as NCHW views, which are
channels_last in memory, so no copy is made. On CUDA the UNet runs under bf16
autocast and the diffusion arithmetic stays fp32.

``use_ddim`` samples by DDIM (eta 0) instead of the ancestral chain, over the
diffusion's respaced steps (``timestep_respacing="ddim50"``).
``parallel_window > 0`` samples the ancestral chain by sliding-window Picard
iteration (``sampling/parallel.py``), opt-in as in JAX.
``generate_layer_progressive`` also records the denoising trajectory.
``plan_workload`` splits an N-sample workload into chains of the batch sizes
of a cost table, and ``generate_workload`` runs them.

Several ranks (``parallel/mesh.py``): ``generate_layer_sharded`` splits a
layer's batch over a mesh and gathers the samples to every rank (the
reference's cross-rank sample all_gather, triplane_sample_layered.py:211-219),
and ``generate_all_layers(mesh=)`` chains it; ``parallel_mesh`` splits each
Picard window's slots over the ranks instead.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from humanliff_tpu_torch.diffusion.gaussian import GaussianDiffusion, StepNoise
from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import DataMesh
from humanliff_tpu_torch.sampling.parallel import parallel_p_sample_loop

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
    parallel_window: int = 0,
    parallel_tol: float = 5e-3,
    parallel_mesh: Optional[DataMesh] = None,
) -> torch.Tensor:
    """Sample one layer: (B, H, W, C) in [-1, 1] by the DDPM ancestral chain,
    or by DDIM with ``use_ddim``. ``parallel_window > 0`` runs the ancestral
    chain by Picard iteration (``parallel_p_sample_loop``) with that window
    and ``parallel_tol``, its slots split over ``parallel_mesh`` if given; it
    cannot be combined with ``use_ddim``.

    ``noise`` / ``step_noise`` inject x_T and the per-step noise (see
    ``GaussianDiffusion.p_sample_loop``); otherwise they come from
    ``generator`` (Picard: a ``TimestepNoise`` seeded from it).
    """
    if parallel_window and use_ddim:
        raise ValueError("parallel_window implements the ancestral (DDPM) chain; "
                         "it cannot be combined with use_ddim")
    device = torch.device(device)
    shape, x_cond, y = _layer_inputs(layer_idx, x_cond, batch_size, image_size, channels,
                                     device)
    model_fn = _model_fn(model, device.type == "cuda")
    if parallel_window:
        samples, _ = parallel_p_sample_loop(
            diffusion, model_fn, shape, generator, x_cond, y, window=parallel_window,
            tol=parallel_tol, clip_denoised=clip_denoised, noise=noise,
            step_noise=step_noise, device=device, mesh=parallel_mesh)
        return samples
    loop = diffusion.ddim_sample_loop if use_ddim else diffusion.p_sample_loop
    return loop(
        model_fn, shape, generator=generator,
        x_cond=x_cond, noise=noise, step_noise=step_noise,
        clip_denoised=clip_denoised, model_kwargs={"y": y}, device=device,
    )


@torch.no_grad()
def generate_layer_sharded(
    model,
    diffusion: GaussianDiffusion,
    layer_idx: int,
    x_cond: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    batch_size: int,
    image_size: int,
    channels: int,
    mesh: DataMesh,
    use_ddim: bool = False,
    clip_denoised: bool = True,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[StepNoise] = None,
    device="cuda",
) -> torch.Tensor:
    """:func:`generate_layer` with the batch split over ``mesh``: each rank
    draws the global batch's noise (x_T and every step's) from ``generator``,
    seeded alike on every rank, takes its rows, runs the chain on them, and
    the samples (B, H, W, C) are gathered to every rank. ``x_cond`` (B, ...),
    ``noise`` and ``step_noise`` are the global batch's. The draws are the
    one-process chain's, so the two agree but for the batch size the model
    runs at."""
    if batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} must divide over {mesh.size} ranks")
    device = torch.device(device)
    rows = mesh.rows(batch_size)
    shape = (batch_size, image_size, image_size, channels)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    if step_noise is None:
        drawn = lambda i: torch.randn(shape, generator=generator, device=device)  # noqa: E731
    else:
        drawn = step_noise if callable(step_noise) else step_noise.__getitem__
    samples = generate_layer(
        model, diffusion, layer_idx, None if x_cond is None else x_cond[rows], None,
        batch_size // mesh.size, image_size, channels, clip_denoised=clip_denoised,
        noise=noise[rows], step_noise=lambda i: drawn(i)[rows], device=device,
        use_ddim=use_ddim)
    return coll.gather_rows(samples.contiguous(), mesh)


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
    parallel_window: int = 0,
    parallel_tol: float = 5e-3,
    mesh: Optional[DataMesh] = None,
    parallel_mesh: Optional[DataMesh] = None,
) -> Dict[str, torch.Tensor]:
    """The progressive chain; returns ``{layer_name: (B, H, W, C)}``.

    ``noises[k] = (x_T, step_noise)`` injects layer k's noise; otherwise it is
    drawn from ``generator``. ``callback(name, samples)`` runs after each layer.
    ``parallel_window``, ``parallel_tol``, ``parallel_mesh``: Picard sampling
    of each layer (:func:`generate_layer`). With ``mesh`` each layer's batch
    splits over the ranks (:func:`generate_layer_sharded`) and the chain
    conditions on the gathered previous layer.
    """
    if mesh is not None and parallel_window:
        raise ValueError("mesh splits the batch of the sequential chain; a Picard window "
                         "splits over parallel_mesh")
    out: Dict[str, torch.Tensor] = {}
    x_cond = None
    for k in range(num_layers):
        noise, step_noise = noises[k] if noises is not None else (None, None)
        if mesh is not None:
            samples = generate_layer_sharded(
                model, diffusion, k, x_cond, generator, batch_size, image_size, channels,
                mesh, use_ddim=use_ddim, noise=noise, step_noise=step_noise, device=device)
        else:
            samples = generate_layer(
                model, diffusion, k, x_cond, generator, batch_size, image_size, channels,
                noise=noise, step_noise=step_noise, device=device, use_ddim=use_ddim,
                parallel_window=parallel_window, parallel_tol=parallel_tol,
                parallel_mesh=parallel_mesh,
            )
        name = LAYER_NAMES[k] if k < len(LAYER_NAMES) else f"layer_{k}"
        out[name] = samples
        if callback is not None:
            callback(name, samples)
        x_cond = samples
    return out


# Seconds for one 4-layer x 250-step chain at the flagship geometry (27 x 256
# x 256, 192 channels, bf16 weights and autocast, channels_last), by batch
# size: 4 DDPM steps of generate_layer timed by CUDA events (median of 3)
# times 1,000 / 4, measured by chip_smoke.py's quality phase (check 6) on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit. Only the batch sizes in
# the table are planned with.
DEFAULT_CHAIN_COSTS: Dict[int, float] = {1: 70.012, 8: 175.223}


def plan_workload(num_samples: int,
                  chain_costs: Optional[Dict[int, float]] = None) -> List[int]:
    """Cheapest partition of an N-sample workload into per-chain batch sizes.

    The reference's sample script runs 25 subjects x 4 layers strictly at B=1
    (triplane_scripts/SynBody_triplane_sample_layered_*.sh). This solves the
    covering problem exactly by DP: ``cost[n]`` = cheapest set of chains whose
    batch sizes sum to >= n (overshoot = padded samples, allowed), drawn from
    ``chain_costs`` (default :data:`DEFAULT_CHAIN_COSTS`). Returns the batch
    sizes, largest first.
    """
    costs = dict(chain_costs or DEFAULT_CHAIN_COSTS)
    if num_samples <= 0:
        return []
    best = [0.0] + [math.inf] * num_samples
    choice = [0] * (num_samples + 1)
    for n in range(1, num_samples + 1):
        for b, c in costs.items():
            prev = best[max(n - b, 0)] + c
            if prev < best[n]:
                best[n] = prev
                choice[n] = b
    plan = []
    n = num_samples
    while n > 0:
        plan.append(choice[n])
        n = max(n - choice[n], 0)
    return sorted(plan, reverse=True)


def generate_workload(
    model,
    diffusion: GaussianDiffusion,
    generator: Optional[torch.Generator],
    num_samples: int,
    image_size: int = 256,
    channels: int = 27,
    num_layers: int = 4,
    use_ddim: bool = False,
    chain_costs: Optional[Dict[int, float]] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """N-sample layered generation under :func:`plan_workload`'s plan.

    Chain-major: each planned group runs its whole layer chain before the
    next group starts, so conditioning stays within the group and peak memory
    is one group's chain. The padded lanes of the last group are computed and
    discarded. Returns ``{layer_name: (num_samples, H, W, C)}`` on ``device``.
    """
    per_layer: Dict[str, List[torch.Tensor]] = {}
    produced = 0
    for B in plan_workload(num_samples, chain_costs):
        take = min(B, num_samples - produced)
        if take <= 0:
            break
        out = generate_all_layers(model, diffusion, generator, batch_size=B,
                                  image_size=image_size, channels=channels,
                                  num_layers=num_layers, device=device, use_ddim=use_ddim)
        for name, arr in out.items():
            per_layer.setdefault(name, []).append(arr[:take])
        produced += take
    return {name: torch.cat(parts) for name, parts in per_layer.items()}
