"""Stage-1 reconstruction training: the tri-plane table and the shared decoder
(port of ``humanliff_tpu/train/stage1.py``; reference run_nerf_batch.py:227-330).

The loss (run_nerf_batch.py:253-262): image MSE + 0.1 x acc (mask) MSE over
the valid rays, plus TV and L1 of the batch's active (instance, layer) plane
slices, taken from the fp32 master planes. After each update the whole table
is clamped to [-1, 1].

State: the table ``planes`` ``(N, L, 3, C3, D, D)`` and the decoder as one
flat fp32 buffer (``nerf/decoder.py::FlatDecoder``), both fp32 masters. A
step gathers the batch's slices by advanced indexing; its backward is a dense
gradient of the whole table in which repeated (instance, layer) pairs add up,
as JAX's gather VJP does, and the two-group Adam (``train/optim.py``) then
updates every element of the table, touched or not.

Randomness (stratified jitter, fine samples, density noise) comes from one
``torch.Generator``; None is the deterministic path (no jitter, linspace fine
samples, no noise). The JAX step splits its key per item and renders with the
first split only, so the two packages agree only on the deterministic path.

``use_bf16`` renders from bf16 copies of the batch's plane slices: features
and directions reach the decoder kernel in bf16, the decoder's weights stay
fp32. The JAX package casts the decoder's weights to bf16 as well, so its bf16
MLP rounds where this one does not (tests/test_torch_stage1.py names the
gap). Canonical-space (TightCap) training needs the body models (ROADMAP A11)
and raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from humanliff_tpu_torch.nerf.decoder import FlatDecoder, NeRFDecoder, flatten_state_dict
from humanliff_tpu_torch.nerf.renderer import RenderConfig, render_rays_batch
from humanliff_tpu_torch.train.optim import Stage1Optimizer, clamp_planes_

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    num_instances: int = 1
    num_layers: int = 4
    triplane_dim: int = 256
    triplane_ch: int = 27  # total channels across the 3 planes
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    tv_loss_coef: float = 1e-4
    l1_loss_coef: float = 1e-4
    acc_loss_coef: float = 0.1
    use_clamp: bool = True
    use_canonical_space: bool = False  # TightCap mode: not ported (ROADMAP A11)
    use_bf16: bool = False  # bf16 render inputs (fp32 master planes and decoder)


@dataclasses.dataclass
class Stage1State:
    """``params`` = {"planes", "decoder" (flat)}; ``opt_state`` per group,
    None for a frozen decoder; ``tx`` the optimizer."""

    step: int
    params: Tensors
    opt_state: Dict[str, Optional[dict]]
    tx: Stage1Optimizer


def init_params(cfg: Stage1Config, seed: int = 0, device=None) -> Tensors:
    """The tri-plane table N(0, 0.1^2) (renderer.py:26-27), drawn on ``device``
    from a generator seeded ``seed``, and the decoder at PyTorch's
    ``nn.Linear`` initialisation (the reference's; flax draws LeCun-normal
    kernels and zero biases) under the same seed."""
    device = torch.device(device or "cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.num_instances, cfg.num_layers, 3, cfg.triplane_ch // 3,
             cfg.triplane_dim, cfg.triplane_dim)
    planes = 0.1 * torch.randn(shape, generator=gen, device=device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        decoder = flatten_state_dict(NeRFDecoder().state_dict(), device)
    return {"planes": planes, "decoder": decoder}


def create_train_state(params: Tensors, tx: Stage1Optimizer, step: int = 0) -> Stage1State:
    """A state over ``params`` (taken, not copied) with fresh optimizer state."""
    return Stage1State(step=step, params=params, opt_state=tx.init(params), tx=tx)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's derivative, +1 at 0 (``torch.abs`` has 0 there).
    It matters after the clamp: neighbouring texels both at +-1 have a TV
    difference of exactly 0."""
    return torch.where(x >= 0, x, -x)


def _masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MSE over the valid rays only; the mask broadcasts over trailing dims."""
    while mask.dim() < pred.dim():
        mask = mask[..., None]
    se = (pred - target) ** 2 * mask
    return se.sum() / torch.clamp((torch.ones_like(se) * mask).sum(), min=1.0)


def stage1_loss(
    params: Tensors,
    batch: Tensors,
    cfg: Stage1Config,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Tensors]:
    """Total loss and aux metrics (img_loss, acc_loss, tv, l1, psnr) of one
    batch: ``instance_idx`` and ``layer_idx`` (B,), rays_o / rays_d / rgb
    (B, R, 3), near / far / bkgd_msk / ray_mask (B, R), box_warp (B, 2, 3)."""
    if cfg.use_canonical_space:
        raise NotImplementedError("canonical-space (TightCap) Stage-1 training needs the "
                                  "SMPL body models; see ROADMAP A11")
    planes_b = params["planes"][batch["instance_idx"].long(), batch["layer_idx"].long()]
    render_planes = planes_b.to(torch.bfloat16) if cfg.use_bf16 else planes_b
    out = render_rays_batch(FlatDecoder(params["decoder"]), render_planes, batch["rays_o"],
                            batch["rays_d"], batch["near"], batch["far"], batch["box_warp"],
                            cfg.render, generator=generator)
    mask = batch.get("ray_mask")
    if mask is None:
        mask = torch.ones_like(batch["near"])
    img_loss = _masked_mse(out["rgb"].float(), batch["rgb"], mask)
    acc_loss = _masked_mse(out["acc"].float(), batch["bkgd_msk"], mask)

    # TV + L1 on the active plane slices (run_nerf_batch.py:255-259), fp32 masters.
    tv = (_abs(planes_b[..., 1:, :] - planes_b[..., :-1, :]).mean()
          + _abs(planes_b[..., :, 1:] - planes_b[..., :, :-1]).mean())
    l1 = _abs(planes_b).mean()
    loss = (img_loss + cfg.acc_loss_coef * acc_loss + cfg.tv_loss_coef * tv
            + cfg.l1_loss_coef * l1)
    psnr = -10.0 * torch.log(torch.clamp(img_loss, min=1e-10)) / math.log(10.0)
    return loss, {"img_loss": img_loss, "acc_loss": acc_loss, "tv": tv, "l1": l1, "psnr": psnr}


def train_step(
    state: Stage1State,
    batch: Tensors,
    cfg: Stage1Config,
    generator: Optional[torch.Generator] = None,
) -> Tensors:
    """One step on ``state`` in place: loss, backward, the two-group Adam over
    the whole table and the decoder (unless frozen), then the clamp. Returns
    the aux metrics and ``loss``, detached 0-d tensors on the state's device."""
    names = [n for n in ("planes", "decoder") if state.opt_state.get(n) is not None]
    params = {n: p.detach().requires_grad_(n in names) for n, p in state.params.items()}
    loss, aux = stage1_loss(params, batch, cfg, generator)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
    state.opt_state = state.tx.step_(state.params, grads, state.opt_state)
    del grads
    if cfg.use_clamp:
        clamp_planes_(state.params["planes"])
    state.step += 1
    out = {k: v.detach() for k, v in aux.items()}
    out["loss"] = loss.detach()
    return out


def state_payload(state: Stage1State) -> dict:
    """The checkpoint of ``state``: step, planes, the flat decoder and both
    groups' Adam moments and counts (tensors as they lie; a save writes each
    once)."""
    return {"step": state.step, "planes": state.params["planes"],
            "decoder": state.params["decoder"], "opt_state": state.opt_state}


def restore_into(state: Stage1State, restored: dict) -> None:
    """Load a checkpoint (:func:`state_payload`'s dict) into ``state`` in place."""
    state.step = int(restored["step"])
    for name in ("planes", "decoder"):
        if tuple(restored[name].shape) != tuple(state.params[name].shape):
            raise ValueError(f"checkpoint {name} {tuple(restored[name].shape)} does not "
                             f"match the model's {tuple(state.params[name].shape)}")
        state.params[name].copy_(restored[name])
    for name, st in state.opt_state.items():
        if st is None:
            continue
        saved = restored["opt_state"].get(name)
        if saved is None:
            raise ValueError(f"checkpoint has no optimizer state for {name}")
        st["mu"].copy_(saved["mu"])
        st["nu"].copy_(saved["nu"])
        st["count"] = int(saved["count"])
