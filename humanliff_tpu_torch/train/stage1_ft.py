"""Per-subject tri-plane fine-tuning with the frozen shared decoder (port of
``humanliff_tpu/train/stage1_ft.py``; reference run_nerf_batch_ft.py).

The decoder freezes (:124-129). A single-instance plane table starts from the
shared table's instance 0 at layer 0 (:111-113) and from this subject's
fitted layer k-1 at layer k (:114-119); each (subject, layer) trains 2000
steps with the plane lr halving every 500 (:294-299) and a fresh Adam; the
output is a tri-plane-only npz per subject (:323-333), which
``data/triplane_data.py`` packs for Stage 2.

``finetune_subjects_batched`` fits N subjects in one table of N instances:
the decoder is frozen, so the fits are independent, and Adam's per-element
normalisation cancels the 1/N of the batch mean. With ``mesh`` the table
shards by instance over the ranks (``train/stage1.py``), the form of the
reference's subject range per GPU (run_nerf_batch_ft.py:348-360): the batch
is built subject by subject, so each rank builds and renders only its own
subjects' rows, which fall in its own instances; each rank writes its
subjects' npz files. ``body_model`` is the canonical-space (TightCap) fits'
body model, handed to every step.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from humanliff_tpu_torch.bodymodel.smpl import BodyModel
from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import DataMesh, instance_range
from humanliff_tpu_torch.train.checkpoint import save_subject_planes
from humanliff_tpu_torch.train.optim import make_finetune_optimizer
from humanliff_tpu_torch.train.stage1 import Stage1Config, create_train_state, train_step

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    steps_per_layer: int = 2000
    plane_lr: float = 1e-1
    lr_decay_every: int = 500
    save_step: int = 2000


def _fit_layers(shared_params: Dict[str, torch.Tensor], n_subjects: int,
                next_batch: Callable[[int, int], Batch], cfg: Stage1Config,
                ft_cfg: FinetuneConfig, generator: Optional[torch.Generator],
                log_every: int, label: str, body_model: Optional[BodyModel],
                mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """Fit every layer of ``n_subjects`` subjects in one table; returns
    (n_subjects, L, 3, C3, D, D) on the table's device, or with ``mesh`` this
    rank's shard of it."""
    tx = make_finetune_optimizer(ft_cfg.plane_lr, ft_cfg.lr_decay_every)
    ncfg = dataclasses.replace(cfg, num_instances=n_subjects)
    n_local = n_subjects
    if mesh is not None:
        lo, hi = instance_range(n_subjects, mesh)
        n_local = hi - lo
    # Every subject starts from the shared table's first instance.
    planes = shared_params["planes"][0:1].to(torch.float32).repeat(
        n_local, *([1] * (shared_params["planes"].dim() - 1)))
    params = {"planes": planes, "decoder": shared_params["decoder"]}
    fitted: List[torch.Tensor] = []
    for layer in range(cfg.num_layers):
        if layer > 0:  # cascade warm start from this subject's layer k-1
            planes[:, layer].copy_(fitted[-1])
        state = create_train_state(params, tx)
        for step in range(ft_cfg.steps_per_layer):
            aux = train_step(state, next_batch(layer, step), ncfg, generator, body_model, mesh)
            if log_every and (step + 1) % log_every == 0:
                print(f"[{label} layer {layer}] step {step + 1} psnr {float(aux['psnr']):.2f}")
        fitted.append(planes[:, layer].clone())
    return torch.stack(fitted, dim=1)


def finetune_subject(
    shared_params: Dict[str, torch.Tensor],
    subject_batches: Callable[[int], Batch],
    cfg: Stage1Config,
    ft_cfg: FinetuneConfig,
    out_dir: str,
    subject_name: str,
    generator: Optional[torch.Generator] = None,
    log_every: int = 200,
    body_model: Optional[BodyModel] = None,
) -> np.ndarray:
    """Fit all layers of one subject; returns planes (L, 3, C3, D, D) and
    writes ``{subject_name}_{save_step:06d}.npz``. ``shared_params`` is
    ``{"planes", "decoder" (flat)}`` of a Stage-1 state; the decoder is not
    touched. ``subject_batches(layer)`` returns a batch whose
    ``instance_idx`` is 0."""
    os.makedirs(out_dir, exist_ok=True)
    planes = _fit_layers(shared_params, 1, lambda layer, step: subject_batches(layer), cfg,
                         ft_cfg, generator, log_every, f"ft {subject_name}", body_model)[0]
    out = planes.cpu().numpy()
    save_subject_planes(os.path.join(out_dir, f"{subject_name}_{ft_cfg.save_step:06d}.npz"),
                        out, ft_cfg.save_step)
    return out


def finetune_subjects_batched(
    shared_params: Dict[str, torch.Tensor],
    subject_batches: Callable[[int, int], Batch],
    cfg: Stage1Config,
    ft_cfg: FinetuneConfig,
    out_dir: str,
    subject_names,
    generator: Optional[torch.Generator] = None,
    log_every: int = 200,
    body_model: Optional[BodyModel] = None,
    mesh: Optional[DataMesh] = None,
) -> np.ndarray:
    """Fit all layers of N subjects concurrently; returns (N, L, 3, C3, D, D)
    and writes one npz per subject. ``subject_batches(pos, layer)`` returns
    one subject's batch; its ``instance_idx`` and ``layer_idx`` are set here
    to the subject's slot and the layer. With ``mesh`` (N divisible by its
    size) each rank fits and writes its own subjects, is called back for
    those only, and every rank returns all N."""
    os.makedirs(out_dir, exist_ok=True)
    names = list(subject_names)
    lo, hi = (0, len(names)) if mesh is None else instance_range(len(names), mesh)

    def next_batch(layer, step):
        parts = []
        for i in range(lo, hi):
            b = dict(subject_batches(i, layer))
            n = b["rays_o"].shape[0]
            b["instance_idx"] = torch.full((n,), i, dtype=torch.long, device=b["rays_o"].device)
            b["layer_idx"] = torch.full((n,), layer, dtype=torch.long, device=b["rays_o"].device)
            parts.append(b)
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    planes = _fit_layers(shared_params, len(names), next_batch, cfg, ft_cfg, generator,
                         log_every, f"ft-batched x{len(names)}", body_model, mesh)
    for i in range(lo, hi):
        save_subject_planes(os.path.join(out_dir, f"{names[i]}_{ft_cfg.save_step:06d}.npz"),
                            planes[i - lo].cpu().numpy(), ft_cfg.save_step)
    if mesh is not None:
        planes = coll.gather_rows(planes, mesh)
    return planes.cpu().numpy()
