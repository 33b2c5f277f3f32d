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
gap).

Canonical space (``use_canonical_space``, TightCap): batches carry each
item's SMPL arrays (``poses``, ``betas``, ``t_poses``, ``smpl_verts``, ``R``,
``Th``); every sample point, and in the fine pass every view direction, goes
from world to SMPL space (directions translated by Th too, as the reference
does) and by the batched inverse-LBS (``bodymodel/canonical.py``) into the
big pose before the lookup, with ``box_warp`` the big pose's bounds. The step
still launches the decoder kernel twice, coarse and fine.

Several ranks (``mesh``, ``parallel/mesh.py``): the table shards by instance,
rank r holding instances ``[r N/W, (r+1) N/W)`` and their Adam moments, and
each rank's batch is its B/W rows of the global batch. A step gathers the
global batch's (instance, layer) indices; each owner writes the requested
slices into a zero ``(B, 3, C3, D, D)`` buffer, and one all-reduce gives every
rank the batch's planes (14 MB at B 2, D 256: never the whole table). Each
rank renders its rows. The loss decomposes over ranks: the masked MSEs'
denominators and the TV and L1 element counts are the global batch's, so
the sum of the ranks' gradients is the one-process gradient. The gradient of
the planes buffer and the decoder's are all-reduced; each owner adds its
rows into its shard's dense gradient (repeated slices accumulate), and the
dense Adam and the clamp run over the shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from humanliff_tpu_torch.bodymodel.canonical import (
    deform_to_canonical_batched,
    world_to_smpl,
)
from humanliff_tpu_torch.bodymodel.smpl import BodyModel
from humanliff_tpu_torch.nerf.decoder import FlatDecoder, NeRFDecoder, flatten_state_dict
from humanliff_tpu_torch.nerf.renderer import RenderConfig, render_rays_batch
from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import DataMesh, instance_range
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
    use_canonical_space: bool = False  # TightCap mode
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


def _masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """MSE over the valid rays only; the mask broadcasts over trailing dims.
    With ``mesh``: this rank's squared errors over the global count."""
    while mask.dim() < pred.dim():
        mask = mask[..., None]
    se = (pred - target) ** 2 * mask
    count = (torch.ones_like(se) * mask).sum().detach()
    if mesh is not None:
        coll.all_reduce_(count, mesh)
    return se.sum() / torch.clamp(count, min=1.0)


def _mean(x: torch.Tensor, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """The mean of ``x``; with ``mesh``, this rank's sum over the global count
    (every rank's ``x`` has the same shape)."""
    return x.sum() / (x.numel() * (1 if mesh is None else mesh.size))


def canonical_deform(batch: Tensors, body_model: BodyModel):
    """The batched deform of canonical-space training (JAX stage1.py:132-145):
    (pts (B, M, 3), dirs (B, M, 3) or None) in world space -> the big pose."""
    def deform(pts, dirs):
        R, Th = batch["R"], batch["Th"]
        return deform_to_canonical_batched(
            body_model, batch["poses"], batch["betas"], batch["t_poses"], batch["smpl_verts"],
            world_to_smpl(pts, R, Th), None if dirs is None else world_to_smpl(dirs, R, Th))
    return deform


def stage1_loss(
    params: Tensors,
    batch: Tensors,
    cfg: Stage1Config,
    generator: Optional[torch.Generator] = None,
    body_model: Optional[BodyModel] = None,
    planes_b: Optional[torch.Tensor] = None,
    mesh: Optional[DataMesh] = None,
) -> Tuple[torch.Tensor, Tensors]:
    """Total loss and aux metrics (img_loss, acc_loss, tv, l1, psnr) of one
    batch: ``instance_idx`` and ``layer_idx`` (B,), rays_o / rays_d / rgb
    (B, R, 3), near / far / bkgd_msk / ray_mask (B, R), box_warp (B, 2, 3);
    in canonical space also poses / t_poses (B, J*3), betas (B, n),
    smpl_verts (B, V, 3), R (B, 3, 3), Th (B, 3) and ``body_model``.
    ``planes_b``: the batch's plane slices, where not taken from
    ``params["planes"]``. With ``mesh``: this rank's share of the global
    loss, whose sum over the ranks is the global batch's loss; the aux
    metrics are then the global ones."""
    deform = None
    if cfg.use_canonical_space:
        if body_model is None:
            raise ValueError("canonical-space training needs the body model")
        deform = canonical_deform(batch, body_model)
    if planes_b is None:
        planes_b = params["planes"][batch["instance_idx"].long(), batch["layer_idx"].long()]
    render_planes = planes_b.to(torch.bfloat16) if cfg.use_bf16 else planes_b
    out = render_rays_batch(FlatDecoder(params["decoder"]), render_planes, batch["rays_o"],
                            batch["rays_d"], batch["near"], batch["far"], batch["box_warp"],
                            cfg.render, generator=generator, deform_fn=deform)
    mask = batch.get("ray_mask")
    if mask is None:
        mask = torch.ones_like(batch["near"])
    img_loss = _masked_mse(out["rgb"].float(), batch["rgb"], mask, mesh)
    acc_loss = _masked_mse(out["acc"].float(), batch["bkgd_msk"], mask, mesh)

    # TV + L1 on the active plane slices (run_nerf_batch.py:255-259), fp32 masters.
    tv = (_mean(_abs(planes_b[..., 1:, :] - planes_b[..., :-1, :]), mesh)
          + _mean(_abs(planes_b[..., :, 1:] - planes_b[..., :, :-1]), mesh))
    l1 = _mean(_abs(planes_b), mesh)
    loss = (img_loss + cfg.acc_loss_coef * acc_loss + cfg.tv_loss_coef * tv
            + cfg.l1_loss_coef * l1)
    aux = {"img_loss": img_loss, "acc_loss": acc_loss, "tv": tv, "l1": l1}
    if mesh is not None:
        aux = dict(zip(aux, coll.sum_scalars(list(aux.values()), mesh)))
    aux["psnr"] = -10.0 * torch.log(torch.clamp(aux["img_loss"], min=1e-10)) / math.log(10.0)
    return loss, aux


def _gather_planes(shard: torch.Tensor, batch: Tensors, mesh: DataMesh):
    """The global batch's plane slices on every rank, from the owners' shards.
    Returns (planes (B_global, 3, C3, D, D), the rows this rank owns, and
    their (instance in the shard, layer) indices)."""
    idx = coll.all_gather(torch.stack([batch["instance_idx"].long(),
                                       batch["layer_idx"].long()], dim=1), mesh)
    inst = idx[:, 0] - mesh.rank * shard.shape[0]
    own = (inst >= 0) & (inst < shard.shape[0])
    where = (inst[own], idx[own, 1])
    buf = torch.zeros((idx.shape[0], *shard.shape[2:]), dtype=shard.dtype,
                      device=shard.device)
    buf[own] = shard[where]
    return coll.all_reduce_(buf, mesh), own, where


def _sharded_grads(state: Stage1State, batch: Tensors, cfg: Stage1Config, names,
                   generator, body_model, mesh: DataMesh):
    """The loss, aux metrics and gradients of a step with the table sharded by
    instance (module docstring): the planes' gradient is this rank's shard's."""
    shard = state.params["planes"]
    buf, own, where = _gather_planes(shard, batch, mesh)
    buf.requires_grad_("planes" in names)
    decoder = state.params["decoder"].detach().requires_grad_("decoder" in names)
    loss, aux = stage1_loss({"decoder": decoder}, batch, cfg, generator, body_model,
                            planes_b=buf[mesh.rows(buf.shape[0])], mesh=mesh)
    leaves = {"planes": buf, "decoder": decoder}
    grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
    for g in grads.values():
        coll.all_reduce_(g, mesh)
    if "planes" in grads:  # repeated slices add up
        grads["planes"] = torch.zeros_like(shard).index_put_(where, grads["planes"][own],
                                                             accumulate=True)
    (loss,) = coll.sum_scalars([loss], mesh)
    return loss, aux, grads


def train_step(
    state: Stage1State,
    batch: Tensors,
    cfg: Stage1Config,
    generator: Optional[torch.Generator] = None,
    body_model: Optional[BodyModel] = None,
    mesh: Optional[DataMesh] = None,
) -> Tensors:
    """One step on ``state`` in place: loss, backward, the two-group Adam over
    the whole table and the decoder (unless frozen), then the clamp. Returns
    the aux metrics and ``loss``, detached 0-d tensors on the state's device.
    With ``mesh``, ``state`` holds this rank's shard of the table
    (``parallel/mesh.py::shard_stage1_params``), ``batch`` this rank's rows,
    and the metrics are the global batch's."""
    names = [n for n in ("planes", "decoder") if state.opt_state.get(n) is not None]
    if mesh is None:
        params = {n: p.detach().requires_grad_(n in names) for n, p in state.params.items()}
        loss, aux = stage1_loss(params, batch, cfg, generator, body_model)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
    else:
        loss, aux, grads = _sharded_grads(state, batch, cfg, names, generator, body_model,
                                          mesh)
    state.opt_state = state.tx.step_(state.params, grads, state.opt_state)
    del grads
    if cfg.use_clamp:
        clamp_planes_(state.params["planes"])
    state.step += 1
    out = {k: v.detach() for k, v in aux.items()}
    out["loss"] = loss.detach()
    return out


def state_payload(state: Stage1State, mesh: Optional[DataMesh] = None) -> Optional[dict]:
    """The checkpoint of ``state``: step, planes, the flat decoder and both
    groups' Adam moments and counts (tensors as they lie; a save writes each
    once). With ``mesh`` every rank calls it: the shards of the table and of
    its moments are gathered into host memory on rank 0, which gets the
    payload (the one-process format); the others get None."""
    if mesh is None:
        return {"step": state.step, "planes": state.params["planes"],
                "decoder": state.params["decoder"], "opt_state": state.opt_state}
    planes = coll.gather_rows_to_root(state.params["planes"], mesh)
    opt = dict(state.opt_state)
    if opt.get("planes") is not None:
        opt["planes"] = {k: coll.gather_rows_to_root(opt["planes"][k], mesh)
                         for k in ("mu", "nu")}
        opt["planes"]["count"] = state.opt_state["planes"]["count"]
    if mesh.rank != 0:
        return None
    return {"step": state.step, "planes": planes, "decoder": state.params["decoder"],
            "opt_state": opt}


def restore_into(state: Stage1State, restored: dict, mesh: Optional[DataMesh] = None) -> None:
    """Load a checkpoint (:func:`state_payload`'s dict) into ``state`` in
    place; with ``mesh`` the table and its moments take this rank's shard, so
    a checkpoint of any world size resumes."""
    state.step = int(restored["step"])
    rows = slice(None)
    if mesh is not None:
        rows = slice(*instance_range(int(restored["planes"].shape[0]), mesh))
    for name in ("planes", "decoder"):
        saved = restored[name][rows] if name == "planes" else restored[name]
        if tuple(saved.shape) != tuple(state.params[name].shape):
            raise ValueError(f"checkpoint {name} {tuple(restored[name].shape)} does not "
                             f"match the model's {tuple(state.params[name].shape)}")
        state.params[name].copy_(saved)
    for name, st in state.opt_state.items():
        if st is None:
            continue
        saved = restored["opt_state"].get(name)
        if saved is None:
            raise ValueError(f"checkpoint has no optimizer state for {name}")
        part = rows if name == "planes" else slice(None)
        st["mu"].copy_(saved["mu"][part])
        st["nu"].copy_(saved["nu"][part])
        st["count"] = int(saved["count"])
