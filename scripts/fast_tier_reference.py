#!/usr/bin/env python3
"""The JAX package's fast-vs-exact agreement on the scene ``chip_smoke.py``
decodes: the fitted campaign planes (campaign0000, layer 3, bf16), the fitted
Stage-1 decoder (fp32 weights), orbit view 0 at 512^2 in the box
[-1, -1.2, -1]..[1, 1.2, 1], 128 + 128 samples, a 128^3 density grid and
``early_term_eps`` 1e-2.

    JAX_PLATFORMS=cpu python3 scripts/fast_tier_reference.py [--size 512]

Prints one JSON line: the rgb PSNR of ``render_image_fast`` against
``render_image_masked`` over the in-box rays, and the in-box rays the fast
tier left at zero accumulated alpha (its terminated rays, and any whose
density underflows to 0). The fast tier is an approximation of the exact
one, and this is how close the JAX package itself comes on that scene;
``chip_smoke.py`` holds the port's fast tier on the card to it. Runs on the
CPU in about four minutes at 512^2 (8 cores).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--view", type=int, default=0)
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from humanliff_tpu.data.raygen import full_image_rays
    from humanliff_tpu.data.view_datasets import NovelViewCameras
    from humanliff_tpu.nerf.decoder import NeRFDecoder
    from humanliff_tpu.nerf.fastpath import build_density_grid, render_image_fast
    from humanliff_tpu.nerf.renderer import RenderConfig, render_image_masked
    from humanliff_tpu.train.checkpoint import load_decoder_npz

    params = load_decoder_npz(os.path.join(REPO, "runs/quality/train/decoder_060000.npz"))
    with np.load(os.path.join(REPO, "runs/quality/stage2/planes/campaign0000_060000.npz")) as z:
        planes = jnp.asarray(z["tri_planes"][3], jnp.bfloat16)
    dec = NeRFDecoder()
    S = args.size
    K, R, T = NovelViewCameras(S).camera(args.view)
    ro, rd, near, far, mask = full_image_rays(S, S, K, R, T, BOUNDS)
    cfg = RenderConfig(n_samples=128, n_importance=128, perturb=False, density_noise=False)
    t0 = time.perf_counter()
    exact = render_image_masked(dec, params, planes, ro, rd, near, far, mask,
                                jnp.asarray(BOUNDS), cfg)
    grid = build_density_grid(dec, params, planes, BOUNDS, resolution=128)
    fast = render_image_fast(dec, params, planes, grid, ro, rd, near, far, mask, BOUNDS, cfg,
                             early_term_eps=1e-2)
    e, f = np.asarray(exact["rgb"])[mask], np.asarray(fast["rgb"])[mask]
    mse = float(np.mean((e.astype(np.float64) - f) ** 2))
    fast_acc = np.asarray(fast["acc"])[mask]
    out = {"size": S, "view": args.view, "in_box_rays": int(mask.sum()),
           "zero_acc_rays": int((fast_acc == 0).sum()),
           "fast_vs_exact_rgb_psnr_db": -10.0 * float(np.log10(mse)),
           "cpu_seconds": time.perf_counter() - t0}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
