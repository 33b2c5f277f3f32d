"""Stock image sampling CLI (port of ``humanliff_tpu/cli/image_sample.py``;
reference scripts/image_sample.py).

    python -m humanliff_tpu_torch.cli.image_sample --model_dir logs/diffusion \\
        --num_samples 16 --batch_size 4

The legacy improved-diffusion capability: samples from a trained model
without the layer chain, with a zero x_cond, and with class labels drawn
uniformly from the four layers when ``--class_cond`` is set (0 otherwise).
Writes ``samples_{N}x{S}x{S}x{C}.npz``: the samples, then the labels only
for class-conditional sampling. Flags and weights are ``diff_sample``'s
(``--model_dir`` or ``--model_npz``, ``--device``, ``--use_ddim``, ...).

Differences from the JAX CLI: labels and noise come from one seeded
``torch.Generator`` on the device, not from JAX key splits; a nonzero
``--parallel_window`` (parsed by the shared parser; the JAX CLI ignores it)
is refused, since this sampler runs the sequential chain.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from humanliff_tpu_torch.cli.diff_sample import _load_model, build_parser
from humanliff_tpu_torch.sampling.layered import _model_fn
from humanliff_tpu_torch.utils.config import device_for
from humanliff_tpu_torch.utils.runtime import setup_runtime


def main(argv=None) -> str:
    setup_runtime()
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.parallel_window:
        parser.error("--parallel_window: image_sample runs the sequential chain")
    device = device_for(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    model, diffusion = _load_model(args, device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    model_fn = _model_fn(model, device.type == "cuda")
    loop = diffusion.ddim_sample_loop if args.use_ddim else diffusion.p_sample_loop

    S, C, B = args.image_size, args.in_channels, args.batch_size
    outs, labels = [], []
    done = 0
    while done < args.num_samples:
        if args.class_cond:
            y = torch.randint(0, 4, (B,), generator=generator, device=device)
        else:
            y = torch.zeros(B, dtype=torch.int64, device=device)
        x_cond = torch.zeros(B, S, S, C, device=device)
        sample = loop(model_fn, (B, S, S, C), generator=generator, x_cond=x_cond,
                      model_kwargs={"y": y}, device=device)
        outs.append(sample.cpu().numpy())
        if args.class_cond:
            labels.append(y.cpu().numpy())
        done += B
        print(f"created {done}/{args.num_samples} samples")

    arr = np.concatenate(outs)[: args.num_samples]
    path = os.path.join(args.out_dir, f"samples_{arr.shape[0]}x{S}x{S}x{C}.npz")
    if labels:
        np.savez(path, arr, np.concatenate(labels)[: args.num_samples])
    else:
        np.savez(path, arr)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
