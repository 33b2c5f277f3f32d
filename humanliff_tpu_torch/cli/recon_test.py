"""Stage-1 evaluation CLI (port of ``humanliff_tpu/cli/recon_test.py``;
reference recon_NeRF/lib/all_test.py via run_nerf_batch --test).

    python -m humanliff_tpu_torch.cli.recon_test --config configs/SynBody.txt \\
        --data_set_type synthetic --basedir logs --expname SynBody_triplane_256 \\
        --triplane_dir triplanes --start_idx 0 --end_idx 2 [--fast_eval true]

loads the decoder of the latest shared checkpoint under ``{basedir}/{expname}``
and each subject's fine-tuned planes ``{triplane_dir}/subject{NNNN}_002000.npz``,
renders the held-out views of each layer (``eval/harness.py``) and writes
pred/gt PNGs, ``metrics.json`` and ``metrics.npy`` under ``--savedir``
(default ``{expdir}/testset_{step:06d}``).

Differences from the JAX CLI: ``--device`` (default ``cuda``; ``cpu`` on
request). The synthetic dataset's held-out views are its ``test_item``s (the
JAX CLI asks every dataset for ``poses_num``, which the synthetic one lacks).
SynBody/TightCap and the canonical-space eval wait for the body models
(ROADMAP A11).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from humanliff_tpu_torch.cli.recon_train import build_dataset
from humanliff_tpu_torch.eval.harness import default_test_views, evaluate_views
from humanliff_tpu_torch.nerf.decoder import FlatDecoder, NeRFDecoder
from humanliff_tpu_torch.nerf.renderer import RenderConfig
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.utils import config as cfglib
from humanliff_tpu_torch.utils.config import device_for


def build_parser():
    parser = cfglib.stage1_parser()
    parser.add_argument("--triplane_dir", type=str, default="./triplanes")
    parser.add_argument("--savedir", type=str, default=None)
    parser.add_argument("--fast_eval", type=cfglib.str2bool, default=False,
                        help="density-grid fast render tier for eval views "
                             "(nerf/fastpath.py); default keeps the exact hierarchy")
    return parser


def main(argv=None):
    args = cfglib.parse_with_config(build_parser(), argv)
    args.train_split = "test"
    device = device_for(args.device)

    expdir = os.path.join(args.basedir, args.expname)
    restored, step = ckpt.restore_state(expdir)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {expdir}")
    decoder = NeRFDecoder()
    decoder.load_state_dict(FlatDecoder(restored["decoder"]).state_dict())
    decoder = decoder.to(device).eval()
    del restored
    savedir = args.savedir or os.path.join(expdir, f"testset_{step:06d}")
    if args.use_canonical_space:
        raise NotImplementedError("--use_canonical_space needs the SMPL body models "
                                  "(ROADMAP A11)")
    dataset, _ = build_dataset(args)
    cfg = RenderConfig(n_samples=args.n_samples, n_importance=args.n_importance,
                       perturb=False, density_noise=False, white_bkgd=args.white_bkgd)

    all_metrics = {}
    for subj in range(args.start_idx, min(args.end_idx, args.num_instance)):
        planes_all = ckpt.load_subject_planes(
            os.path.join(args.triplane_dir, f"subject{subj:04d}_002000.npz"))
        layers = [args.test_layer_id] if args.test_layer_id is not None else range(4)
        for layer in layers:
            items = [dataset.test_item(subj, layer, v)
                     for v in default_test_views(layer, args.test_layer_id)]
            planes = torch.from_numpy(np.ascontiguousarray(planes_all[layer])).to(device)
            agg = evaluate_views(decoder, planes, items, cfg, savedir=savedir,
                                 tag=f"s{subj:04d}_l{layer}", fast=args.fast_eval)
            all_metrics[f"subject{subj}_layer{layer}"] = agg
            print(f"subject {subj} layer {layer}: {agg}")

    os.makedirs(savedir, exist_ok=True)
    with open(os.path.join(savedir, "metrics.json"), "w") as f:
        json.dump(all_metrics, f, indent=2)
    np.save(os.path.join(savedir, "metrics.npy"), all_metrics)
    return all_metrics


if __name__ == "__main__":
    main(sys.argv[1:])
