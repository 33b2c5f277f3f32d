#!/usr/bin/env python3
"""Where a 512^2 view of the port's decode spends its time, on one GPU, by tier.

    python3 scripts/profile_torch_decode.py

Decodes orbit view 0 of the fitted campaign planes (layer 3, bf16) with the
fitted Stage-1 decoder, as chip_smoke.py does, by the exact tier
(``render_image_masked``) and by the fast tier (``build_density_grid`` +
``render_image_fast``, grid 128^3, early_term_eps 1e-2). Each tier runs once
to warm up, once untraced (host clock after a synchronize) and once under
``torch.profiler``; it prints the wall seconds, the device milliseconds and
busy share, and the operators and kernels that take most of the device time.
The last lines are the card's name and power limit and one JSON summary.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from profile_torch_step import _device_us  # importing it puts the repo on sys.path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=12, help="rows per table")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from humanliff_tpu_torch.data.raygen import full_image_rays
    from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
    from humanliff_tpu_torch.nerf.fastpath import build_density_grid, render_image_fast
    from humanliff_tpu_torch.nerf.renderer import RenderConfig, render_image_masked

    device = torch.device("cuda", 0)
    dec = chip_smoke.load_fitted_decoder(device)
    planes = chip_smoke.load_fitted_planes(3).to(device=device, dtype=torch.bfloat16)
    box = chip_smoke.BOUNDS
    K, R, T = NovelViewCameras(512).camera(0)
    rays = full_image_rays(512, 512, K, R, T, box)
    cfg = RenderConfig(n_samples=128, n_importance=128, perturb=False, density_noise=False)

    tiers = {
        "exact": lambda: render_image_masked(dec, planes, *rays, box, cfg, outputs=("rgb",)),
        "fast": lambda: render_image_fast(
            dec, planes, build_density_grid(dec, planes, box, resolution=128), *rays, box,
            cfg, early_term_eps=1e-2, outputs=("rgb",)),
    }
    summary = {}
    for name, fn in tiers.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        ops = [e for e in events
               if e.device_type != torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
        device_ms = sum(_device_us(e) for e in on_device) / 1e3
        launches = sum(e.count for e in on_device)
        print(f"[{name}] untraced {wall_s:.4f} s wall; traced: {device_ms:.3f} ms on the "
              f"device, {launches} kernels, busy share of the untraced view "
              f"{device_ms / 1e3 / wall_s:.3f}")
        for title, group in (("operators by the device time of their kernels", ops),
                             ("kernels", on_device)):
            print(f"[{name}] {title}:")
            for e in sorted(group, key=_device_us, reverse=True)[:args.top]:
                print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")
        summary[name] = {"wall_s": wall_s, "device_ms": device_ms, "kernels": launches}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    print(json.dumps({**summary, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
