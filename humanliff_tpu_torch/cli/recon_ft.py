"""Per-subject fine-tune CLI (port of ``humanliff_tpu/cli/recon_ft.py``;
reference recon_NeRF/run_nerf_batch_ft.py).

    python -m humanliff_tpu_torch.cli.recon_ft --config configs/SynBody.txt \\
        --data_set_type synthetic --basedir logs --expname SynBody_triplane_256 \\
        --start_idx 0 --end_idx 2 --ft_steps 2000 --out_dir triplanes

loads the shared Stage-1 checkpoint of ``{basedir}/{expname}`` (the port's
own, ``recon_train``'s), freezes its decoder and fits a fresh tri-plane for
each subject in ``[start_idx, end_idx)`` and each of its 4 layers, writing
``{out_dir}/subject{NNNN}_002000.npz`` (``tri_planes`` (4, 3, C3, D, D)),
the files ``data/triplane_data.py::pack_subject_planes`` packs for Stage 2.
``--subjects_per_batch K`` fits K subjects at once in one table.

Several GPUs: under ``torchrun`` the K-subject table shards by instance over
the N ranks (N must divide ``--subjects_per_batch``): each rank fits and
writes K/N of each group's subjects, drawing their items from a generator
seeded by (seed, rank) (the JAX CLI shards the table over its devices with
one item stream; the reference splits subjects over GPUs).

Differences from the JAX CLI: ``--device`` (default ``cuda``; ``cpu`` on
request); items are drawn from one numpy generator seeded ``--seed`` (the JAX
CLI seeds one per batch from its key).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from humanliff_tpu_torch.cli.recon_train import (
    build_dataset,
    canonical_body_model,
    stage1_config,
    to_device,
)
from humanliff_tpu_torch.parallel.mesh import cli_mesh
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.train.stage1_ft import (
    FinetuneConfig,
    finetune_subject,
    finetune_subjects_batched,
)
from humanliff_tpu_torch.utils import config as cfglib
from humanliff_tpu_torch.utils.runtime import setup_runtime


def build_parser():
    parser = cfglib.stage1_parser()
    parser.add_argument("--ft_steps", type=int, default=2000)
    parser.add_argument("--out_dir", type=str, default="./triplanes")
    parser.add_argument("--subjects_per_batch", type=int, default=1,
                        help=">1 fits that many subjects at once in one plane table "
                             "(the frozen decoder makes them independent)")
    return parser


def load_shared(expdir: str, device) -> dict:
    """Instance 0 of the shared table and the frozen decoder of the latest
    checkpoint under ``expdir`` (only that slice of the table is read)."""
    restored, step = ckpt.restore_state(expdir)
    if restored is None:
        raise FileNotFoundError(f"no shared checkpoint under {expdir}")
    print(f"loaded shared checkpoint at step {step}")
    return {"planes": restored["planes"][0:1].to(device),
            "decoder": restored["decoder"].to(device)}


def main(argv=None):
    setup_runtime()
    args = cfglib.parse_with_config(build_parser(), argv)
    device, mesh = cli_mesh(args.device, args.dist_backend)
    group = max(1, args.subjects_per_batch)
    if mesh is not None and group % mesh.size:
        raise ValueError(f"--subjects_per_batch {group} does not divide over the "
                         f"{mesh.size} ranks: each rank fits an equal share of a group")
    expdir = os.path.join(args.basedir, args.expname)
    shared = load_shared(expdir, device)

    dataset, body_model = build_dataset(args)
    body_model = canonical_body_model(args, body_model)
    # As in the JAX CLI, the fine-tune renders in fp32 whatever --use_bf16 says.
    cfg = dataclasses.replace(stage1_config(args), use_bf16=False)
    seed = args.seed + (0 if mesh is None else 1000 * mesh.rank)
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    per_layer = getattr(dataset, "poses_num", 1) * getattr(dataset, "views_num", 64)

    def subject_batch(subj: int, layer: int):
        """``batch_size`` random views of one (subject, layer)."""
        items = []
        for _ in range(args.batch_size):
            view = int(rng.integers(0, per_layer))
            item = dict(dataset.item(subj * 4 * per_layer + layer * per_layer + view, rng))
            item["instance_idx"] = np.int32(0)  # single-instance table
            items.append(item)
        return to_device({k: np.stack([it[k] for it in items]) for k in items[0]}, device)

    ft_cfg = FinetuneConfig(steps_per_layer=args.ft_steps)
    subjects = list(range(args.start_idx, min(args.end_idx, args.num_instance)))
    for g0 in range(0, len(subjects), group):
        chunk = subjects[g0:g0 + group]
        if group == 1:
            finetune_subject(shared, lambda layer, s=chunk[0]: subject_batch(s, layer), cfg,
                             ft_cfg, args.out_dir, f"subject{chunk[0]:04d}", generator,
                             body_model=body_model)
        else:
            finetune_subjects_batched(
                shared, lambda pos, layer, c=chunk: subject_batch(c[pos], layer), cfg, ft_cfg,
                args.out_dir, [f"subject{s:04d}" for s in chunk], generator,
                body_model=body_model, mesh=mesh)
        print(f"finished subjects {chunk}")


if __name__ == "__main__":
    main(sys.argv[1:])
