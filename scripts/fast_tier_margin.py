#!/usr/bin/env python3
"""How far the port's fast tier sits from its exact tier on chip_smoke.py's
fitted scene, run to run, and what faulty fast tiers read there.

    python3 scripts/fast_tier_margin.py [--repeats 3] [--size 512] [--device cuda]

Decodes orbit view 0 of the fitted campaign planes (layer 3, bf16) with the
fitted Stage-1 decoder in chip_smoke's box, 128 + 128 samples: the exact tier
(``render_image_masked``) once, the fast tier as the CLI runs it (128^3 grid,
``early_term_eps`` 1e-2) ``--repeats`` times, each from a fresh grid, and
variants of the fast tier:

- ``eps_x10``: ``early_term_eps`` 1e-1, so rays with some density terminate;
- ``grid_64``: a 64^3 grid, so the fine samples are placed from a coarser field;
- ``table_fp32``: the grid's table, and so its lookup sums, in fp32 instead
  of the planes' bf16 (the JAX package sums in bf16);
- ``no_termination``: ``early_term_eps`` 0, so only rays of zero estimated
  alpha are dropped;
- ``axes_swapped``: the table's x and z lattice axes swapped, an indexing fault.

Prints each one's rgb PSNR against the exact tier over the in-box rays and
its terminated rays, then the card's name and power limit, and one JSON line.
``chip_smoke.FITTED_FAST_VS_EXACT_DB`` is set between the sound fast tier's
readings and the faulty ones below them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3, help="runs of the sound fast tier")
    ap.add_argument("--size", type=int, default=512, help="the view's width and height")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from humanliff_tpu_torch.data.raygen import full_image_rays
    from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
    from humanliff_tpu_torch.nerf.fastpath import (
        DensityGrid,
        build_density_grid,
        render_image_fast,
    )
    from humanliff_tpu_torch.nerf.renderer import RenderConfig, render_image_masked

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("fast_tier_margin: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dec = chip_smoke.load_fitted_decoder(device)
    planes = chip_smoke.load_fitted_planes(3).to(device=device, dtype=torch.bfloat16)
    box = chip_smoke.BOUNDS
    S = args.size
    K, R, T = NovelViewCameras(S).camera(0)
    rays = full_image_rays(S, S, K, R, T, box)
    mask = rays[4]
    cfg = RenderConfig(n_samples=128, n_importance=128, perturb=False, density_noise=False)
    exact = render_image_masked(dec, planes, *rays, box, cfg, outputs=("rgb",))
    exact_rgb = exact["rgb"].cpu().numpy()[mask]

    def grid(resolution=chip_smoke.GRID_RESOLUTION):
        return build_density_grid(dec, planes, box, resolution=resolution)

    def swapped(g):
        n = g.resolution + 1
        t = g.table.reshape(n, n, n, 8).transpose(0, 2).reshape(n ** 3, 8).contiguous()
        return DensityGrid(table=t, resolution=g.resolution)

    def fp32(g):
        return DensityGrid(table=g.table.float(), resolution=g.resolution)

    eps = chip_smoke.EARLY_TERM_EPS
    runs = [(f"sound_{i}", grid, eps) for i in range(args.repeats)] + [
        ("eps_x10", grid, 10 * eps),
        ("grid_64", lambda: grid(64), eps),
        ("table_fp32", lambda: fp32(grid()), eps),
        ("no_termination", grid, 0.0),
        ("axes_swapped", lambda: swapped(grid()), eps),
    ]
    readings = {}
    for name, make_grid, run_eps in runs:
        out = render_image_fast(dec, planes, make_grid(), *rays, box, cfg,
                                early_term_eps=run_eps, outputs=("rgb", "acc"))
        rgb = out["rgb"].cpu().numpy()[mask]
        terminated = int((out["acc"].cpu().numpy()[mask] == 0).sum())
        readings[name] = {"psnr_db": chip_smoke.psnr_db(rgb, exact_rgb),
                          "zero_acc_rays": terminated}
        print(f"[margin] {name}: fast vs exact rgb PSNR {readings[name]['psnr_db']:.4f} dB "
              f"over {int(mask.sum())} in-box rays; {terminated} at zero acc", flush=True)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    print(json.dumps({"size": S, "readings": readings, "device": str(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
