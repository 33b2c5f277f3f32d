#!/usr/bin/env python3
"""The JAX package's Stage-1 numbers on the committed fitted pair, the
reference that ``chip_smoke.py``'s recon phase holds the card to.

    JAX_PLATFORMS=cpu python3 scripts/stage1_jax_reference.py \\
        [--out runs/quality/stage1_jax_reference.json]

The pair is the Stage-1 campaign's decoder (``runs/quality/train/
decoder_060000.npz``) and its two subjects' planes
(``runs/quality/stage2/planes/campaign000{0,1}_060000.npz``), on the
campaign's dataset: the synthetic layered bodies at image 128 with tight
bounds. It writes one json with

- ``eval``: the exact tier's held-out views (``eval/harness.py::
  evaluate_views``; the default test views of each layer, 128 + 128
  samples, chunks of 4096 rays) per subject, layer and view: mse, psnr, ssim;
- ``loss``: the deterministic ``stage1_loss`` of the pair (planes of both
  subjects as a (2, 4, 3, 9, 256, 256) table) on a fixed batch of two
  seeded synthetic items of 512 rays each (``batch``: their indices and
  seeds), 128 + 128 samples, no jitter, no density noise and linspace fine
  samples (the renderer is handed no key), TV and L1 at 1e-4.

This script imports JAX and the JAX package on purpose; the card has
neither. It runs on the CPU in about 80 s (8 Intel Xeon cores: 78.5 s).
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
DECODER = "runs/quality/train/decoder_060000.npz"
PLANES = ["runs/quality/stage2/planes/campaign0000_060000.npz",
          "runs/quality/stage2/planes/campaign0001_060000.npz"]
IMAGE_SIZE = 128
N_SAMPLES = 128
# (dataset index, item seed): (subject 0, layer 3, view 5) and (subject 1,
# layer 1, view 40) of the 4 x 64 views per subject.
LOSS_ITEMS = [[197, 11], [360, 12]]
LOSS_RAYS = 512


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "quality",
                                                  "stage1_jax_reference.json"))
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from humanliff_tpu.data.synthetic import SyntheticLayeredDataset
    from humanliff_tpu.eval.harness import default_test_views, evaluate_views
    from humanliff_tpu.nerf import renderer
    from humanliff_tpu.nerf.decoder import NeRFDecoder
    from humanliff_tpu.train import stage1
    from humanliff_tpu.train.checkpoint import load_decoder_npz

    t0 = time.perf_counter()
    params = load_decoder_npz(os.path.join(REPO, DECODER))
    planes = np.stack([np.load(os.path.join(REPO, p))["tri_planes"] for p in PLANES])
    dec = NeRFDecoder()
    cfg = renderer.RenderConfig(n_samples=N_SAMPLES, n_importance=N_SAMPLES, perturb=False,
                                density_noise=False)
    ds = SyntheticLayeredDataset(num_instances=2, n_rays=LOSS_RAYS, image_size=IMAGE_SIZE,
                                 tight_bounds=True)
    views = {}
    for subject in range(2):
        for layer in range(4):
            for view in default_test_views(layer):
                item = ds.test_item(subject, layer, view)
                agg = evaluate_views(dec, params, jnp.asarray(planes[subject, layer]), [item],
                                     cfg, chunk=4096, tag=f"s{subject}_l{layer}")
                views[f"s{subject}_l{layer}_v{view}"] = {
                    k: agg[k] for k in ("mse", "psnr", "ssim")}
    eval_s = time.perf_counter() - t0

    # stage1_loss hands its renderer a key, which draws the fine samples at
    # random: render without one, as the port's generator=None does.
    keyed = renderer.render_rays_batch
    stage1.render_rays_batch = lambda *a, key=None, **kw: keyed(*a, key=None, **kw)
    items = [ds.item(i, np.random.default_rng(s)) for i, s in LOSS_ITEMS]
    batch = {k: jnp.asarray(np.stack([it[k] for it in items])) for k in items[0]}
    s1cfg = stage1.Stage1Config(num_instances=2, render=cfg)
    loss, aux = stage1.stage1_loss({"planes": jnp.asarray(planes), "decoder": params}, batch,
                                   dec, s1cfg, jax.random.key(0))
    out = {
        "decoder": DECODER, "planes": PLANES, "image_size": IMAGE_SIZE,
        "n_samples": N_SAMPLES, "n_importance": N_SAMPLES, "chunk": 4096,
        "eval": views,
        "batch": {"items": LOSS_ITEMS, "n_rays": LOSS_RAYS, "image_size": IMAGE_SIZE,
                  "tight_bounds": True, "tv_loss_coef": s1cfg.tv_loss_coef,
                  "l1_loss_coef": s1cfg.l1_loss_coef, "acc_loss_coef": s1cfg.acc_loss_coef},
        "loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
        "cpu_seconds": {"eval": eval_s, "total": time.perf_counter() - t0},
        "jax": jax.__version__,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"loss": out["loss"], "cpu_seconds": out["cpu_seconds"],
                      "mean_psnr": float(np.mean([v["psnr"] for v in views.values()]))}))
    return out


if __name__ == "__main__":
    main()
