#!/usr/bin/env python3
"""Where a denoising step of the port's flagship UNet spends its time, on one GPU.

    python3 scripts/profile_torch_step.py [--steps 10]

Builds the full-width ControlNet UNet of chip_smoke.py (seeded random weights,
bf16, channels_last), runs ``generate_layer`` for a few respaced DDPM steps
untraced (host clock after a synchronize) and then under ``torch.profiler``,
and prints per step: wall milliseconds, summed device-kernel milliseconds,
the device's busy share, kernel launches, and the kernels that take most of
the device time. The last lines are the card's name and power limit and one
JSON summary. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import device_us as _device_us  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10, help="DDPM steps per timed run")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from humanliff_tpu_torch.models.factory import create_model_and_diffusion
    from humanliff_tpu_torch.sampling.layered import generate_layer

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(device):
        model, diffusion = create_model_and_diffusion(timestep_respacing=str(args.steps))
    chip_smoke.seed_weights(model, 0)
    model.eval().to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    gen = torch.Generator(device=device).manual_seed(0)

    def run():
        out = generate_layer(model, diffusion, 1, None, gen, device=device)
        torch.cuda.synchronize()
        return out

    run()  # warm-up: cuDNN algorithm choice, allocator
    t0 = time.perf_counter()
    run()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        traced_wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    events = prof.key_averages()
    # Kernels and copies on the device; the operators that launched them carry
    # the same time again as their own "self device time".
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events
           if e.device_type != torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in on_device) / 1e3 / args.steps
    launches = sum(e.count for e in on_device) / args.steps
    print(f"untraced: {wall_ms:.3f} ms/step wall; traced: {traced_wall_ms:.3f} ms/step "
          f"wall, {device_ms:.3f} ms/step on the device, {launches:.0f} kernels/step, "
          f"busy share of the untraced step {device_ms / wall_ms:.3f}")
    for title, group in (("operators by the device time of their kernels", ops),
                         ("kernels", on_device)):
        print(title + ":")
        for e in sorted(group, key=_device_us, reverse=True)[:10]:
            print(f"  {_device_us(e) / 1e3 / args.steps:9.3f} ms/step"
                  f"  {e.count / args.steps:6.0f}x  {e.key[:100]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    print(json.dumps({
        "steps": args.steps, "wall_ms_per_step": wall_ms,
        "traced_wall_ms_per_step": traced_wall_ms, "device_ms_per_step": device_ms,
        "kernels_per_step": launches, "busy_share": device_ms / wall_ms,
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
