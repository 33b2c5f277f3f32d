"""Super-resolution sampling CLI (port of ``humanliff_tpu/cli/sr_sample.py``;
reference scripts/super_res_sample.py).

    python -m humanliff_tpu_torch.cli.sr_sample --model_dir logs/sr \\
        --low_res_npz low.npz --num_samples 4

Upsamples low-resolution images by ancestral sampling of the SR diffusion
model conditioned on them, with the EMA weights of the first
``--ema_rate`` of an ``sr_train`` checkpoint (``--model_dir``, its latest
step). The inputs are the first array of ``--low_res_npz`` ((N, s, s, C),
its first ``--num_samples``) or seeded N(0, 0.4^2) images. Writes
``sr_samples_{large_size}.npz``. The model flags are ``sr_train``'s.

Differences from the JAX CLI: noise comes from one seeded
``torch.Generator`` on the device, not from JAX key splits; ``--device`` as
in ``sr_train``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from humanliff_tpu_torch.cli.sr_train import build_parser, build_sr_model
from humanliff_tpu_torch.diffusion.respace import create_diffusion
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.train.stage2 import model_fn_for
from humanliff_tpu_torch.utils.config import device_for
from humanliff_tpu_torch.utils.runtime import setup_runtime


def main(argv=None) -> str:
    setup_runtime()
    p = build_parser()
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--low_res_npz", type=str, default=None)
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--timestep_respacing", type=str, default="250")
    p.add_argument("--out_dir", type=str, default="./sr_samples")
    args = p.parse_args(argv)
    device = device_for(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    with torch.device(device):
        model = build_sr_model(args)
    diffusion = create_diffusion(steps=args.diffusion_steps, noise_schedule=args.noise_schedule,
                                 learn_sigma=args.learn_sigma,
                                 timestep_respacing=args.timestep_respacing)
    restored, step = ckpt.restore_state(args.model_dir)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {args.model_dir}")
    model.load_state_dict(ckpt.get_field(restored, "ema_params")[args.ema_rate.split(",")[0]],
                          strict=True)
    model.eval()
    print(f"loaded EMA weights from step {step}")

    S, s, C = args.large_size, args.small_size, args.in_channels
    if args.low_res_npz:
        low = ckpt.load_samples_npz(args.low_res_npz)[: args.num_samples]
    else:
        low = np.random.default_rng(0).normal(
            scale=0.4, size=(args.num_samples, s, s, C)).astype(np.float32)

    model_fn = model_fn_for(model)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    outs = []
    for i in range(0, len(low), args.batch_size):
        lo = torch.from_numpy(np.ascontiguousarray(low[i:i + args.batch_size], np.float32))
        lo = lo.to(device)
        sample = diffusion.p_sample_loop(model_fn, (lo.shape[0], S, S, C), generator,
                                         model_kwargs={"low_res": lo}, device=device)
        outs.append(sample.cpu().numpy())
        print(f"upsampled {i + lo.shape[0]}/{len(low)}")
    arr = np.concatenate(outs)
    path = os.path.join(args.out_dir, f"sr_samples_{S}.npz")
    ckpt.save_samples_npz(path, arr)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
