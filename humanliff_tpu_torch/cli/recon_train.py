"""Stage-1 shared-decoder training CLI (port of ``humanliff_tpu/cli/recon_train.py``;
reference recon_NeRF/run_nerf_batch.py).

    python -m humanliff_tpu_torch.cli.recon_train --config configs/SynBody.txt \\
        --data_set_type synthetic --synthetic_image_size 128 --synthetic_tight_bounds true

fits the tri-plane table of ``--num_instance`` instances x 4 layers and the
shared decoder. Checkpoints are ``{basedir}/{expname}/{step:06d}/state.pt``
(with a commit marker) every ``--i_weights`` steps, at step 5000 and at the
end, each with its decoder sidecar ``decoder_{step:06d}.npz``. A run resumes
from its latest checkpoint unless ``--no_reload true``; ``--resume_npz``
continues a JAX run's state (``scripts/export_jax_weights.py --stage1``) when
the directory holds no checkpoint yet.

Differences from the JAX CLI:

- ``--device`` (default ``cuda``) raises when CUDA is missing; ``cpu`` runs
  on the CPU.
- Several GPUs: one process per GPU under ``torchrun``
  (``python -m torch.distributed.run --nproc_per_node N -m
  humanliff_tpu_torch.cli.recon_train ...``), where JAX runs one process over
  all devices. The table shards by instance over the N ranks (N must divide
  ``--num_instance`` and ``--batch_size``, the global batch); each rank reads
  its B/N items from a loader of its own, seeded by (seed, rank), the
  reference's per-rank loaders, where JAX shards one loader's global batch,
  and draws its render noise from a generator seeded by (seed, rank).
  ``--dist_backend gloo`` lets ranks share a card. Rank 0 alone writes the
  logs and the checkpoints, the whole table gathered, in the one-process
  format; any world size resumes them.
- ``--data_set_type SynBody`` reads the SMPL-X models
  ``{--smplx_model_dir}/SMPLX_{GENDER}.npz`` (or ``.pkl``), ``TightCap`` the
  SMPL model ``--smpl_model_path`` (files not in the repository:
  assets/README.md); ``--use_canonical_space true`` (the TightCap config)
  trains through the inverse-LBS deform of the TightCap items' SMPL fits.
- Metrics stay on the device until ``--i_print``; the JAX CLI's per-step
  readback (a workaround for its remote TPU) is not ported. The log also
  carries ``loader_wait_per_iter``, the seconds a step waited for its batch.
- The decoder starts from PyTorch's ``nn.Linear`` initialisation, the planes
  from a ``torch.Generator``, both seeded by ``--seed``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from humanliff_tpu_torch.nerf.decoder import FlatDecoder
from humanliff_tpu_torch.nerf.renderer import RenderConfig
from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import cli_mesh, is_root, shard_stage1_params
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.train.optim import make_stage1_optimizer
from humanliff_tpu_torch.train.stage1 import (
    Stage1Config,
    create_train_state,
    init_params,
    restore_into,
    state_payload,
    train_step,
)
from humanliff_tpu_torch.utils import config as cfglib
from humanliff_tpu_torch.utils import logger as loglib
from humanliff_tpu_torch.utils.runtime import setup_runtime

AUX_KEYS = ("loss", "img_loss", "acc_loss", "tv", "psnr")


def build_dataset(args):
    """The Stage-1 item source and the body model of its canonical-space
    deform (TightCap's SMPL; None for the world-space datasets)."""
    if args.data_set_type == "synthetic":
        from humanliff_tpu_torch.data.synthetic import SyntheticLayeredDataset

        ds = SyntheticLayeredDataset(
            num_instances=args.num_instance,
            n_rays=args.n_rand,
            image_size=args.synthetic_image_size,
            tight_bounds=bool(args.synthetic_tight_bounds),
        )
        return ds, None
    if args.data_set_type == "SynBody":
        from humanliff_tpu_torch.bodymodel.smpl import find_smplx_model, load_body_model
        from humanliff_tpu_torch.data.synbody import SynBodyDataset

        models = {g: load_body_model(find_smplx_model(args.smplx_model_dir, g))
                  for g in ("male", "female", "neutral")}
        return SynBodyDataset(
            data_root=args.data_root, body_models=models, num_instances=args.num_instance,
            pose_start=args.start, pose_interval=args.interval, poses_num=args.poses_num,
            views_num=args.views_num, n_rays=args.n_rand, image_scaling=args.image_scaling,
            layer_idx=args.layer_idx), None
    if args.data_set_type == "TightCap":
        from humanliff_tpu_torch.bodymodel.smpl import load_body_model
        from humanliff_tpu_torch.data.tightcap import TightCapDataset

        body = load_body_model(args.smpl_model_path)
        return TightCapDataset(
            data_root=args.data_root, body_model=body, num_instances=args.num_instance,
            pose_start=args.start, pose_interval=args.interval, poses_num=args.poses_num,
            views_num=args.views_num, n_rays=args.n_rand, image_scaling=args.image_scaling,
            layer_idx=args.layer_idx), body
    raise ValueError(args.data_set_type)


def stage1_config(args) -> Stage1Config:
    return Stage1Config(
        num_instances=args.num_instance,
        num_layers=4,
        triplane_dim=args.triplane_dim,
        triplane_ch=args.triplane_ch,
        render=RenderConfig(n_samples=args.n_samples, n_importance=args.n_importance,
                            perturb=args.perturb > 0, white_bkgd=args.white_bkgd),
        tv_loss_coef=args.tv_loss_coef if args.tv_loss else 0.0,
        l1_loss_coef=args.l1_loss_coef,
        use_clamp=args.use_clamp,
        use_canonical_space=args.use_canonical_space,
        use_bf16=args.use_bf16,
    )


def canonical_body_model(args, body_model):
    """The body model a ``--use_canonical_space`` run deforms with; raises
    for a dataset without one."""
    if args.use_canonical_space and body_model is None:
        raise ValueError("--use_canonical_space needs a body model: --data_set_type TightCap")
    return body_model if args.use_canonical_space else None


def to_device(batch, device):
    """A stacked numpy item batch as tensors on ``device`` (indices int64)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, torch.long)
            if k in ("instance_idx", "layer_idx")
            else torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def save(expdir: str, state, mesh=None) -> Optional[str]:
    """A full checkpoint of ``state`` and its decoder sidecar. With ``mesh``
    every rank gathers, rank 0 writes (the path; None elsewhere), all wait."""
    payload = state_payload(state, mesh)
    path = None
    if payload is not None:
        path = ckpt.save_state(expdir, state.step, payload)
        ckpt.save_decoder_npz(os.path.join(expdir, f"decoder_{state.step:06d}.npz"),
                              FlatDecoder(state.params["decoder"]).state_dict(), state.step)
    del payload
    coll.barrier(mesh)
    return path


def rank_loader(args, dataset, mesh):
    """The Stage-1 item loader of this rank: ``--batch_size`` items from
    ``--seed`` in one process; under a mesh B/W items from a loader seeded by
    (seed, rank), the reference's per-rank loaders (a divergence from JAX,
    which shards one loader's global batch). Also the render generator's
    seed."""
    from humanliff_tpu_torch.data.loader import BatchLoader

    B = args.batch_size if mesh is None else mesh.share(args.batch_size)
    seed = args.seed + (0 if mesh is None else 1000 * mesh.rank)
    return BatchLoader(num_items=len(dataset), item_fn=dataset.item, batch_size=B,
                       seed=seed, num_workers=4), seed


def build_parser():
    parser = cfglib.stage1_parser()
    parser.add_argument("--resume_npz", type=str, default=None,
                        help="a JAX run's Stage-1 state (scripts/export_jax_weights.py "
                             "--stage1) to continue when the run directory has no checkpoint")
    return parser


def main(argv=None):
    setup_runtime()
    args = cfglib.parse_with_config(build_parser(), argv)
    device, mesh = cli_mesh(args.device, args.dist_backend)
    root = is_root(mesh)
    if root:
        cfglib.print_args(args)

    expdir = os.path.join(args.basedir, args.expname)
    os.makedirs(expdir, exist_ok=True)
    if root:
        with open(os.path.join(expdir, "args.txt"), "w") as f:
            for k in sorted(vars(args)):
                f.write(f"{k} = {getattr(args, k)}\n")
    log = loglib.configure(expdir, ["stdout", "csv", "json"] if root else [])

    dataset, body_model = build_dataset(args)
    body_model = canonical_body_model(args, body_model)
    cfg = stage1_config(args)
    tx = make_stage1_optimizer(args.lrate, args.tri_plane_lrate, args.lrate_decay)
    params = init_params(cfg, args.seed, device)
    if mesh is not None:
        params = shard_stage1_params(params, mesh)
    state = create_train_state(params, tx)
    del params

    def restore(payload):  # under a mesh, this rank's shard of the table
        if mesh is None:
            restore_into(state, payload)
        else:
            restore_into(state, payload, mesh)

    restored, start = ckpt.restore_state(expdir)
    if restored is not None and not args.no_reload:
        restore(restored)
        print(f"resumed from step {start}")
    elif restored is None and args.resume_npz:
        from humanliff_tpu_torch.compat.from_jax import load_stage1_npz

        restore(load_stage1_npz(args.resume_npz))
        print(f"resumed the JAX state of {args.resume_npz} at step {state.step}")
    del restored

    loader, seed = rank_loader(args, dataset, mesh)
    it = iter(loader)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    aux_buf = []
    wait = 0.0
    t0 = time.time()
    try:
        while state.step < args.n_iteration:
            t_wait = time.perf_counter()
            batch = to_device(next(it), device)
            wait += time.perf_counter() - t_wait
            aux_buf.append(train_step(state, batch, cfg, generator, body_model, mesh))
            step = state.step
            if step % args.i_print == 0:
                stacked = torch.stack([torch.stack([a[k] for a in aux_buf]) for k in AUX_KEYS])
                means = stacked.float().mean(dim=1).cpu().numpy()
                aux_buf.clear()
                for k, v in zip(AUX_KEYS, means):
                    log.logkv(k, float(v))
                log.logkv("time_per_iter", (time.time() - t0) / args.i_print)
                log.logkv("loader_wait_per_iter", wait / args.i_print)
                t0, wait = time.time(), 0.0
                log.dumpkvs(step)
            if step % args.i_weights == 0 or step == 5000:
                path = save(expdir, state, mesh)
                if root:
                    print(f"saved checkpoint {path}")
    finally:
        loader.close()
    save(expdir, state, mesh)
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
