"""Decode benchmark on a fitted scene: the exact render tier against the fast
tier (port of ``humanliff_tpu/cli/bench_decode.py``).

    python -m humanliff_tpu_torch.cli.bench_decode --ckpt_dir runs/quality_torch/train

Reads a fitted Stage-1 checkpoint of the port (``recon_train``'s or
``recon_refit``'s), renders ``--num_views`` held-out views (145 onward) of one
(subject, layer) at ``--render_size`` through the cameras of the fit, by the
exact masked tier (``render_image_masked``) and by the density-grid fast tier
(``render_image_fast``, the grid built once and amortised), and writes per-view
seconds, their medians, the speedup, the fast-vs-exact PSNR over the in-box
rays and the grid build seconds to ``--out_json`` (the JAX CLI's keys). Times
are host-clock seconds between ``torch.cuda.synchronize()`` calls; the first
view of each tier is warmed up before timing.

Reference measurement this mirrors: all_test.py:153-156 "Time per image" and
the 40-view decode loop of triplane_sample_layered.py:155-176.

Differences from the JAX CLI:

- ``--out_json`` defaults to ``runs/quality_torch/bench_decode.json`` and
  ``--ckpt_dir`` to ``runs/quality_torch/train``: the JAX defaults hold the
  JAX campaign's committed files, and its orbax checkpoints are not read here
  (``scripts/export_jax_weights.py --stage1`` carries one across, or
  ``recon_refit`` rebuilds one from plane exports and a decoder sidecar).
- ``--bf16 true`` renders bf16 planes through the fp32 decoder weights (the
  fused kernel takes fp32 weights); the JAX CLI casts the weights to bf16 too.
- ``--device`` (default ``cuda``, which raises where CUDA is missing; ``cpu``
  on request).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from humanliff_tpu_torch.data.synthetic import SyntheticLayeredDataset
from humanliff_tpu_torch.eval.metrics import mse
from humanliff_tpu_torch.nerf.decoder import FlatDecoder, NeRFDecoder
from humanliff_tpu_torch.nerf.fastpath import GridCache, build_density_grid, render_image_fast
from humanliff_tpu_torch.nerf.renderer import RenderConfig, render_image_masked
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.utils.config import device_for, str2bool


def build_parser():
    p = argparse.ArgumentParser("humanliff_tpu_torch bench-decode")
    p.add_argument("--ckpt_dir", type=str, default="runs/quality_torch/train")
    p.add_argument("--out_json", type=str, default="runs/quality_torch/bench_decode.json")
    p.add_argument("--num_views", type=int, default=8)
    p.add_argument("--render_size", type=int, default=512)
    p.add_argument("--subject", type=int, default=0)
    p.add_argument("--layer", type=int, default=3)
    p.add_argument("--grid_resolution", type=int, default=128)
    p.add_argument("--early_term_eps", type=float, default=1e-2)
    p.add_argument("--bf16", type=str2bool, default=True)
    p.add_argument("--num_instance", type=int, default=2)
    p.add_argument("--train_image_size", type=int, default=128,
                   help="image size the checkpoint was fitted at (campaign default); "
                        "render_size rescales the same cameras")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    return p


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = device_for(args.device)

    restored, step = ckpt.restore_state(args.ckpt_dir)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {args.ckpt_dir}: the bench measures "
                                "a fitted scene (recon_train or recon_refit first)")
    print(f"[bench-decode] checkpoint step {step}")
    decoder = NeRFDecoder(d_in=int(restored["planes"].shape[2] * restored["planes"].shape[3]))
    decoder.load_state_dict(FlatDecoder(restored["decoder"]).state_dict())
    decoder = decoder.to(device).eval()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    planes = restored["planes"][args.subject, args.layer].to(device=device, dtype=dtype)
    planes = planes.contiguous()
    del restored

    # The fitted subject at render_size through the camera model of the fit
    # (K scales linearly with the image size).
    ds = SyntheticLayeredDataset(num_instances=args.num_instance, image_size=args.render_size,
                                 tight_bounds=True)
    views = [ds.test_item(args.subject, args.layer, 145 + v, n_gt_samples=2)
             for v in range(args.num_views)]  # GT quadrature unused: 2 samples keep it cheap
    cfg = RenderConfig(n_samples=128, n_importance=128, perturb=False, density_noise=False)

    def run_exact(item):
        return render_image_masked(decoder, planes, item["rays_o"], item["rays_d"],
                                   item["near"], item["far"], item["ray_mask"],
                                   item["box_warp"], cfg, chunk=16384, outputs=("rgb",))["rgb"]

    def run_fast(item, grid, box):
        return render_image_fast(decoder, planes, grid, item["rays_o"], item["rays_d"],
                                 item["near"], item["far"], item["ray_mask"], box, cfg,
                                 outputs=("rgb",), early_term_eps=args.early_term_eps)["rgb"]

    run_exact(views[0])  # warm-up
    _sync(device)
    grids = GridCache(decoder, planes, resolution=args.grid_resolution)
    box0 = np.asarray(views[0]["box_warp"], np.float32)
    t0 = time.time()
    grid = grids.get(box0)
    run_fast(views[0], grid, box0)
    _sync(device)
    warm_s = time.time() - t0

    exact_times, fast_times, psnrs = [], [], []
    for vi, item in enumerate(views):
        t0 = time.time()
        rgb_exact = run_exact(item)
        _sync(device)
        exact_times.append(time.time() - t0)

        t0 = time.time()
        rgb_fast = run_fast(item, grid, box0)
        _sync(device)
        fast_times.append(time.time() - t0)

        mask = torch.as_tensor(np.asarray(item["ray_mask"]).reshape(-1).astype(bool))
        m = mse(rgb_fast.float().cpu().numpy()[mask.numpy()],
                rgb_exact.float().cpu().numpy()[mask.numpy()])
        psnrs.append(-10.0 * float(np.log10(max(m, 1e-12))))
        print(f"[bench-decode] view {vi}: exact {exact_times[-1]:.4f}s, "
              f"fast {fast_times[-1]:.4f}s, fast-vs-exact {psnrs[-1]:.2f} dB")

    # Grid build cost, measured warm (one rebuild).
    _sync(device)
    t0 = time.time()
    build_density_grid(decoder, planes, box0, resolution=args.grid_resolution)
    _sync(device)
    grid_build_s = time.time() - t0

    result = {
        "checkpoint_step": int(step),
        "render_size": args.render_size,
        "num_views": args.num_views,
        "exact_s_per_view": float(np.mean(exact_times)),
        "fast_s_per_view": float(np.mean(fast_times)),
        "speedup": float(np.mean(exact_times) / np.mean(fast_times)),
        "exact_s_per_view_median": float(np.median(exact_times)),
        "fast_s_per_view_median": float(np.median(fast_times)),
        "speedup_median": float(np.median(exact_times) / max(np.median(fast_times), 1e-9)),
        "fast_vs_exact_psnr_db": float(np.mean(psnrs)),
        "grid_build_s": grid_build_s,
        "fast_first_view_incl_grid_s": warm_s,
        "early_term_eps": args.early_term_eps,
        "dtype": "bf16" if args.bf16 else "fp32",
    }
    os.makedirs(os.path.dirname(args.out_json) or ".", exist_ok=True)
    with open(args.out_json, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
