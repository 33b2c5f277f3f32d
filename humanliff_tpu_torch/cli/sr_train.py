"""Super-resolution diffusion training CLI (port of
``humanliff_tpu/cli/sr_train.py``; reference scripts/super_res_train.py).

    python -m humanliff_tpu_torch.cli.sr_train --data_dir images/ --logdir logs/sr

The legacy improved-diffusion capability: a UNet conditioned on a bilinearly
upsampled low-resolution image joined on channels (``models/unet.py::
SuperResModel``), trained on (high, low) pairs: the images of ``--data_dir``
at ``--large_size`` with their area-pooled ``--small_size`` copies
(``data/image_folder.py``), or with ``--data_dir synthetic`` seeded
N(0, 0.4^2) images and their strided copies. The step is ``diff_train``'s
(``train/stage2.py::train_step``: clipped AdamW and the EMA over flat
buffers, uniform timesteps), in fp32.

Differences from the JAX CLI:

- ``--device`` (default ``cuda``) raises when CUDA is missing; ``cpu`` runs
  on the CPU.
- Logs (``loss`` and ``steps_per_sec`` every ``--log_interval`` steps) and
  saves follow ``diff_train``: the port's checkpoints, one every
  ``--save_interval`` steps and one at the final step (the JAX CLI saves
  only at multiples of ``--save_interval``); ``DIFFUSION_TRAINING_TEST``
  stops after the first periodic save.
- Weights start from PyTorch's initialisation seeded by ``--seed``;
  timesteps and noise come from a ``torch.Generator``.
- ``--class_cond true`` is refused: the step passes no labels (the JAX step
  passes none either, and its class-conditional model fails).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from humanliff_tpu_torch.diffusion.respace import create_diffusion
from humanliff_tpu_torch.models.factory import channel_mult_for
from humanliff_tpu_torch.models.unet import SuperResModel
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.train.stage2 import (
    Stage2Config,
    create_stage2_state,
    state_payload,
    train_step,
)
from humanliff_tpu_torch.utils import logger as loglib
from humanliff_tpu_torch.utils.config import device_for
from humanliff_tpu_torch.utils.runtime import setup_runtime


def _bool(s: str) -> bool:
    return s.lower() == "true"


def build_sr_model(args) -> SuperResModel:
    """The SR UNet: unconditioned (``cond_type=""``), reading x and the
    upsampled image (twice ``--in_channels``)."""
    if args.class_cond:
        raise ValueError("--class_cond true: the super-resolution step passes no labels")
    attention_ds = tuple(args.large_size // int(r) for r in args.attention_resolutions.split(","))
    return SuperResModel(
        in_channels=args.in_channels * 2,
        model_channels=args.num_channels,
        out_channels=args.in_channels * 2 if args.learn_sigma else args.in_channels,
        num_res_blocks=args.num_res_blocks,
        attention_resolutions=attention_ds,
        channel_mult=channel_mult_for(args.large_size),
        num_classes=None,
        num_heads=args.num_heads,
        use_scale_shift_norm=True,
        cond_type="",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("humanliff_tpu_torch sr-train")
    p.add_argument("--large_size", type=int, default=256)
    p.add_argument("--small_size", type=int, default=64)
    p.add_argument("--in_channels", type=int, default=3)
    p.add_argument("--num_channels", type=int, default=128)
    p.add_argument("--num_res_blocks", type=int, default=2)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--attention_resolutions", type=str, default="16,8")
    p.add_argument("--learn_sigma", type=_bool, default=False)
    p.add_argument("--class_cond", type=_bool, default=False)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--noise_schedule", type=str, default="linear")
    p.add_argument("--data_dir", type=str, default="synthetic")
    p.add_argument("--logdir", type=str, default="./logs/sr")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--ema_rate", type=str, default="0.9999")
    p.add_argument("--total_steps", type=int, default=200000)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--save_interval", type=int, default=50000)
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--seed", type=int, default=0)
    return p


def _pairs(args):
    """An iterator of (high, low) NHWC numpy batches."""
    S, s, C, B = args.large_size, args.small_size, args.in_channels, args.batch_size
    if args.data_dir == "synthetic":
        rng = np.random.default_rng(args.seed)
        while True:
            hi = rng.normal(scale=0.4, size=(B, S, S, C)).astype(np.float32)
            yield hi, np.ascontiguousarray(hi[:, ::S // s, ::S // s])
    if not os.path.isdir(args.data_dir):
        raise ValueError(f"--data_dir {args.data_dir!r} is not a directory")
    # Real (high, low) pairs from an image folder: the reference's
    # load_superres_data (super_res_train.py:64 + image_datasets.py).
    from humanliff_tpu_torch.data.image_folder import area_downsample, load_image_data

    for batch in load_image_data(args.data_dir, B, S, seed=args.seed):
        yield batch["x"], area_downsample(batch["x"], s)


def main(argv=None):
    setup_runtime()
    args = build_parser().parse_args(argv)
    device = device_for(args.device)
    os.makedirs(args.logdir, exist_ok=True)
    log = loglib.configure(args.logdir, ["stdout", "csv", "json"])

    torch.manual_seed(args.seed)
    with torch.device(device):
        model = build_sr_model(args)
    diffusion = create_diffusion(steps=args.diffusion_steps, noise_schedule=args.noise_schedule,
                                 learn_sigma=args.learn_sigma)
    cfg = Stage2Config(lr=args.lr, ema_rates=tuple(float(r) for r in args.ema_rate.split(",")),
                       class_cond=False)
    state = create_stage2_state(model, cfg, diffusion.num_timesteps)
    pairs = _pairs(args)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    losses = []
    t0 = time.time()
    while state.step < args.total_steps:
        hi, lo = next(pairs)
        batch = {"x": torch.from_numpy(hi).to(device), "low_res": torch.from_numpy(lo).to(device)}
        losses.append(train_step(state, model, diffusion, cfg, batch, generator=generator)["loss"])
        step = state.step
        if step % args.log_interval == 0:
            log.logkv("loss", float(torch.stack(losses).mean()))
            losses.clear()
            log.logkv("steps_per_sec", args.log_interval / (time.time() - t0))
            t0 = time.time()
            log.dumpkvs(step)
        if step % args.save_interval == 0 and step != args.total_steps:
            print("saved", ckpt.save_state(args.logdir, step, state_payload(state)))
            if os.environ.get("DIFFUSION_TRAINING_TEST"):
                print("DIFFUSION_TRAINING_TEST set: early exit after first save")
                return state
    print("saved", ckpt.save_state(args.logdir, state.step, state_payload(state)))
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
