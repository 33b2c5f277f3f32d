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
  on the CPU. One device, no mesh.
- ``--data_set_type SynBody`` and ``TightCap`` raise: their loaders need the
  SMPL/SMPL-X model files, which are not in the repository (ROADMAP A11).
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

import numpy as np
import torch

from humanliff_tpu_torch.nerf.decoder import FlatDecoder
from humanliff_tpu_torch.nerf.renderer import RenderConfig
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
from humanliff_tpu_torch.utils.config import device_for
from humanliff_tpu_torch.utils import logger as loglib

AUX_KEYS = ("loss", "img_loss", "acc_loss", "tv", "psnr")


def build_dataset(args):
    """The Stage-1 item source and its body model (None in world space)."""
    if args.data_set_type == "synthetic":
        from humanliff_tpu_torch.data.synthetic import SyntheticLayeredDataset

        ds = SyntheticLayeredDataset(
            num_instances=args.num_instance,
            n_rays=args.n_rand,
            image_size=args.synthetic_image_size,
            tight_bounds=bool(args.synthetic_tight_bounds),
        )
        return ds, None
    if args.data_set_type in ("SynBody", "TightCap"):
        raise NotImplementedError(
            f"--data_set_type {args.data_set_type}: its loader and body models need the "
            "SMPL/SMPL-X model files, which are not in the repository (assets/README.md); "
            "see ROADMAP A11. --data_set_type synthetic runs without them.")
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


def to_device(batch, device):
    """A stacked numpy item batch as tensors on ``device`` (indices int64)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, torch.long)
            if k in ("instance_idx", "layer_idx")
            else torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def save(expdir: str, state) -> str:
    """A full checkpoint of ``state`` and its decoder sidecar."""
    path = ckpt.save_state(expdir, state.step, state_payload(state))
    ckpt.save_decoder_npz(os.path.join(expdir, f"decoder_{state.step:06d}.npz"),
                          FlatDecoder(state.params["decoder"]).state_dict(), state.step)
    return path


def build_parser():
    parser = cfglib.stage1_parser()
    parser.add_argument("--resume_npz", type=str, default=None,
                        help="a JAX run's Stage-1 state (scripts/export_jax_weights.py "
                             "--stage1) to continue when the run directory has no checkpoint")
    return parser


def main(argv=None):
    args = cfglib.parse_with_config(build_parser(), argv)
    cfglib.print_args(args)
    device = device_for(args.device)

    expdir = os.path.join(args.basedir, args.expname)
    os.makedirs(expdir, exist_ok=True)
    with open(os.path.join(expdir, "args.txt"), "w") as f:
        for k in sorted(vars(args)):
            f.write(f"{k} = {getattr(args, k)}\n")
    log = loglib.configure(expdir, ["stdout", "csv", "json"])

    dataset, _ = build_dataset(args)
    cfg = stage1_config(args)
    if cfg.use_canonical_space:
        raise NotImplementedError("--use_canonical_space needs the SMPL body models "
                                  "(ROADMAP A11)")
    tx = make_stage1_optimizer(args.lrate, args.tri_plane_lrate, args.lrate_decay)
    state = create_train_state(init_params(cfg, args.seed, device), tx)

    restored, start = ckpt.restore_state(expdir)
    if restored is not None and not args.no_reload:
        restore_into(state, restored)
        print(f"resumed from step {start}")
    elif restored is None and args.resume_npz:
        from humanliff_tpu_torch.compat.from_jax import load_stage1_npz

        restore_into(state, load_stage1_npz(args.resume_npz))
        print(f"resumed the JAX state of {args.resume_npz} at step {state.step}")
    del restored

    from humanliff_tpu_torch.data.loader import BatchLoader

    loader = BatchLoader(num_items=len(dataset), item_fn=dataset.item,
                         batch_size=args.batch_size, seed=args.seed, num_workers=4)
    it = iter(loader)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    aux_buf = []
    wait = 0.0
    t0 = time.time()
    try:
        while state.step < args.n_iteration:
            t_wait = time.perf_counter()
            batch = to_device(next(it), device)
            wait += time.perf_counter() - t_wait
            aux_buf.append(train_step(state, batch, cfg, generator))
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
                print(f"saved checkpoint {save(expdir, state)}")
    finally:
        loader.close()
    save(expdir, state)
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
