"""Decoder recovery: rebuild a full Stage-1 checkpoint from per-subject plane
exports by refitting the shared decoder against the frozen planes (port of
``humanliff_tpu/cli/recon_refit.py``).

    python -m humanliff_tpu_torch.cli.recon_refit \\
        --plane_files 'runs/quality/stage2/planes/campaign*.npz' \\
        --decoder_from runs/quality/train/decoder_060000.npz --refit_steps 0 \\
        --data_set_type synthetic --num_instance 2 --synthetic_image_size 128 \\
        --synthetic_tight_bounds true --basedir runs/quality_torch --expname train

The Stage-1 -> Stage-2 file contract (the reference's) stores per-subject
artifacts with only ``tri_planes`` (run_nerf_batch_ft.py:323-333); the shared
decoder lives in the big shared checkpoint (run_nerf_batch.py:321-330). When
that checkpoint is gone, this CLI recovers a consistent (planes, decoder)
pair:

- The planes load from the export npzs (instance order = file order,
  ``--plane_files`` is a comma-separated list of paths or globs) and are
  frozen by a plane learning rate of 0 in Stage 1's two-group Adam: their
  updates are exactly 0, so they stay bit-identical, and the optimizer state
  keeps ``recon_train``'s layout (the saved state resumes there). TV, L1 and
  the clamp are off.
- The decoder starts from ``--decoder_from`` (a ``decoder_*.npz`` sidecar or
  a Stage-1 checkpoint directory of the port), or else from the target
  directory's latest checkpoint, or else from its seeded initialisation.
  ``--refit_steps 0`` is pure reassembly: the (exports, sidecar) pair becomes
  a full checkpoint.
- The checkpoint is stamped ``--save_step`` (default: the exports' step, from
  their ``_{step:06d}.npz`` names), since the step names plane provenance,
  and gets a decoder sidecar and a ``{step:06d}_REFIT.txt`` record.

Several GPUs: under ``torchrun`` the table shards by instance over a mesh of
``gcd(gcd(world, instances), --batch_size)`` ranks, as the JAX CLI sizes its
mesh (recon_refit.py:168-174); a rank outside it leaves. Each rank reads its
items from a loader seeded by (seed, rank) (``recon_train``); rank 0 writes.

Differences from the JAX CLI: ``--device`` (default ``cuda``, which raises
where CUDA is missing; ``cpu`` on request); ``--decoder_from``
reads the port's checkpoints (a JAX orbax state comes across through
``scripts/export_jax_weights.py --stage1``).
"""

from __future__ import annotations

import glob
import math
import os
import re
import sys
import time

import numpy as np
import torch

from humanliff_tpu_torch.cli.recon_train import (
    AUX_KEYS,
    build_dataset,
    canonical_body_model,
    rank_loader,
    save,
    to_device,
)
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.nerf.decoder import flatten_state_dict
from humanliff_tpu_torch.nerf.renderer import RenderConfig
from humanliff_tpu_torch.parallel.mesh import cli_mesh, is_root, shard_stage1_params
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.train.optim import make_stage1_optimizer
from humanliff_tpu_torch.train.stage1 import (
    Stage1Config,
    create_train_state,
    init_params,
    train_step,
)
from humanliff_tpu_torch.utils import config as cfglib
from humanliff_tpu_torch.utils import logger as loglib
from humanliff_tpu_torch.utils.runtime import setup_runtime


def _expand_plane_files(spec: str):
    parts = []
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        hits = sorted(glob.glob(token))
        parts.extend(hits if hits else [token])
    return parts


def build_parser():
    parser = cfglib.stage1_parser()
    parser.add_argument("--plane_files", type=str, required=True,
                        help="comma-separated npz paths or globs; file order "
                             "defines the instance index")
    parser.add_argument("--refit_steps", type=int, default=2500)
    parser.add_argument("--refit_lr", type=float, default=1e-3,
                        help="decoder lr for the refit (the standard staged decay "
                             "applies on top, from step 0)")
    parser.add_argument("--save_step", type=int, default=None,
                        help="step to stamp the recovered checkpoint with "
                             "(default: the exports' embedded step)")
    parser.add_argument("--decoder_from", type=str, default=None,
                        help="checkpoint dir or decoder_*.npz sidecar to start the "
                             "decoder from (default: the target dir's latest "
                             "checkpoint); with --refit_steps 0 this is pure reassembly")
    return parser


def main(argv=None):
    """Refit and save; returns the state (None on a rank outside the mesh)."""
    setup_runtime()
    args = cfglib.parse_with_config(build_parser(), argv)

    plane_files = _expand_plane_files(args.plane_files)
    if not plane_files:
        raise FileNotFoundError(f"no plane files match {args.plane_files!r}")
    planes = np.stack([ckpt.load_subject_planes(p) for p in plane_files])
    n_inst = planes.shape[0]
    export_steps = [int(m.group(1)) for p in plane_files
                    if (m := re.search(r"_(\d{6})\.npz$", os.path.basename(p)))]
    save_step = args.save_step
    if save_step is None:
        if not export_steps:
            raise ValueError("--save_step required: plane filenames carry no "
                             "_{step:06d}.npz suffix to infer it from")
        save_step = max(export_steps)
    print(f"[refit] {n_inst} subjects from exports (steps {export_steps}), "
          f"checkpoint will be stamped step {save_step}")

    if args.num_instance != n_inst:
        # The synthetic dataset's per-instance geometry depends on
        # num_instance (one RNG stream): it must be the planes' own world.
        raise ValueError(f"--num_instance {args.num_instance} != {n_inst} plane files: "
                         "instance geometry must match the planes' original fit")
    if planes.shape[-1] != args.triplane_dim or 3 * planes.shape[3] != args.triplane_ch:
        raise ValueError(f"plane exports {planes.shape[1:]} do not match --triplane_dim "
                         f"{args.triplane_dim} --triplane_ch {args.triplane_ch}")

    device, mesh = cli_mesh(
        args.device, args.dist_backend,
        lambda world: max(1, math.gcd(math.gcd(world, n_inst), args.batch_size)),
        capped=f"the table of {n_inst} instances and --batch_size {args.batch_size} "
               "must divide over the ranks")
    if mesh is not None and not mesh.member:
        return None
    expdir = os.path.join(args.basedir, args.expname)
    os.makedirs(expdir, exist_ok=True)
    log = loglib.configure(expdir, ["stdout", "csv", "json"] if is_root(mesh) else [])
    dataset, body_model = build_dataset(args)
    body_model = canonical_body_model(args, body_model)

    cfg = Stage1Config(
        num_instances=n_inst,
        num_layers=int(planes.shape[1]),
        triplane_dim=args.triplane_dim,
        triplane_ch=args.triplane_ch,
        render=RenderConfig(n_samples=args.n_samples, n_importance=args.n_importance,
                            perturb=args.perturb > 0, white_bkgd=args.white_bkgd),
        tv_loss_coef=0.0,  # plane regularizers are moot on frozen planes
        l1_loss_coef=0.0,
        use_clamp=False,  # keep the frozen planes bit-identical to the exports
        use_canonical_space=args.use_canonical_space,
        use_bf16=args.use_bf16,
    )
    tx = make_stage1_optimizer(args.refit_lr, 0.0, args.lrate_decay)
    params = init_params(cfg, args.seed, device)
    params["planes"] = torch.from_numpy(planes.astype(np.float32)).to(device)

    warm_dir = args.decoder_from or expdir
    if warm_dir.endswith(".npz"):
        params["decoder"] = flatten_state_dict(
            decoder_state_dict(ckpt.load_decoder_npz(warm_dir)), device)
        warm_step = "sidecar"
        print(f"[refit] decoder loaded from sidecar {warm_dir}")
    else:
        warm, warm_step = ckpt.restore_state(warm_dir)
        if warm is not None:
            params["decoder"] = warm["decoder"].to(device=device, dtype=torch.float32,
                                                   copy=True)
            print(f"[refit] decoder warm-started from {warm_dir} step {warm_step}")
        elif args.refit_steps <= 0:
            raise FileNotFoundError(f"--refit_steps 0 is pure reassembly but {warm_dir} has "
                                    "no checkpoint/sidecar to take the decoder from")
        else:
            print("[refit] no checkpoint to warm-start from: seeded decoder init")
        del warm
    if mesh is not None:
        params = shard_stage1_params(params, mesh)
    state = create_train_state(params, tx)

    if args.refit_steps > 0:
        loader, seed = rank_loader(args, dataset, mesh)
        it = iter(loader)
        generator = torch.Generator(device=device).manual_seed(seed + 1)
        aux_buf = []
        t0 = time.time()
        try:
            for step in range(1, args.refit_steps + 1):
                aux_buf.append(train_step(state, to_device(next(it), device), cfg, generator,
                                          body_model, mesh))
                if step % args.i_print == 0:
                    stacked = torch.stack([torch.stack([a[k] for a in aux_buf])
                                           for k in AUX_KEYS])
                    means = stacked.float().mean(dim=1).cpu().numpy()
                    aux_buf.clear()
                    for k, v in zip(AUX_KEYS, means):
                        log.logkv(k, float(v))
                    log.logkv("time_per_iter", (time.time() - t0) / args.i_print)
                    t0 = time.time()
                    log.dumpkvs(step)
        finally:
            loader.close()

    state.step = save_step
    path = save(expdir, state, mesh)
    if not is_root(mesh):
        return state
    with open(os.path.join(expdir, f"{save_step:06d}_REFIT.txt"), "w") as f:
        f.write(
            "Recovered checkpoint: planes are the UNMODIFIED exports below "
            f"(frozen, plane lr 0); the decoder was refit against them for "
            f"{args.refit_steps} steps at lr {args.refit_lr} "
            f"(warm-start: {warm_dir} step {warm_step})\n"
            + "\n".join(os.path.abspath(p) for p in plane_files) + "\n"
        )
    print(f"[refit] saved recovered checkpoint {path}")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
