"""Bits-per-dim evaluation CLI (port of ``humanliff_tpu/cli/image_nll.py``;
reference scripts/image_nll.py).

    python -m humanliff_tpu_torch.cli.image_nll --model_dir logs/diffusion \\
        --data_npz planes.npz --timestep_respacing 250

Runs the whole variational bound (``GaussianDiffusion.calc_bpd_loop``) over a
dataset with the trained model, a numerical probe of the diffusion math
(gaussian_diffusion.py:792-847), and prints the running mean and the final
bits/dim. The data are the first array of ``--data_npz`` ((N, H, W, C)), the
first ``--num_samples`` images of the image folder ``--data_dir`` in their
sorted order (``data/image_folder.py``), or else seeded N(0, 0.3^2) images.
The model sees a zero x_cond and label 0, and runs in fp32 on every device,
as the JAX CLI's fp32 params do: fp32 weights and no bf16 autocast on the
card, unlike ``diff_sample``. Convolutions follow PyTorch's
``torch.backends.cudnn.allow_tf32`` (on by default; without TF32 an fp32
flagship forward at batch 2 takes about 100x longer on an H100). Flags and
weights are ``diff_sample``'s.

Differences from the JAX CLI: the loop's noise comes from one seeded
``torch.Generator`` on the device, batch after batch, not from JAX key
splits; ``main`` returns the per-image terms; a nonzero ``--parallel_window``
(parsed by the shared parser; the JAX CLI ignores it) is refused.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from humanliff_tpu_torch.cli.diff_sample import _load_model, build_parser
from humanliff_tpu_torch.sampling.layered import _model_fn
from humanliff_tpu_torch.utils.config import device_for
from humanliff_tpu_torch.utils.runtime import setup_runtime


def load_data(args) -> np.ndarray:
    """The images to evaluate, (N, H, W, C) float32."""
    S, C = args.image_size, args.in_channels
    if args.data_npz:
        with np.load(args.data_npz) as z:
            return z[z.files[0]].astype(np.float32)
    if args.data_dir:
        from humanliff_tpu_torch.data.image_folder import ImageFolderDataset

        ds = ImageFolderDataset(args.data_dir, S)
        return np.stack([ds.item(i)[0] for i in range(min(len(ds), args.num_samples))])
    return np.random.default_rng(0).normal(
        scale=0.3, size=(args.num_samples, S, S, C)).astype(np.float32)


def model_fn_for(model):
    """The loop's model function: fp32, a zero x_cond and label 0."""
    base = _model_fn(model, False)

    def model_fn(x, ts, x_cond, y=None):
        x_cond = torch.zeros_like(x) if x_cond is None else x_cond
        y = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device) if y is None else y
        return base(x, ts, x_cond, y)

    return model_fn


def main(argv=None) -> Dict[str, np.ndarray]:
    setup_runtime()
    p = build_parser()
    p.add_argument("--data_npz", type=str, default=None,
                   help="npz of (N, H, W, C) images to evaluate; default random")
    p.add_argument("--data_dir", type=str, default=None,
                   help="image folder to evaluate (reference image_nll data_dir)")
    args = p.parse_args(argv)
    if args.parallel_window:
        p.error("--parallel_window: image_nll evaluates the sequential chain's terms")
    device = device_for(args.device)
    model, diffusion = _load_model(args, device, bf16=False)
    data = load_data(args)
    if not len(data):
        raise ValueError("no images to evaluate")
    model_fn = model_fn_for(model)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    parts = []
    for i in range(0, len(data), args.batch_size):
        x = torch.from_numpy(data[i:i + args.batch_size]).to(device)
        out = diffusion.calc_bpd_loop(model_fn, x, generator)
        parts.append({k: v.cpu().numpy() for k, v in out.items()})
        bpds = np.concatenate([o["total_bpd"] for o in parts])
        print(f"batch {i // args.batch_size}: mean bpd so far {np.mean(bpds):.4f}")
    result = {k: np.concatenate([o[k] for o in parts]) for k in parts[0]}
    print(f"final bits/dim: {np.mean(result['total_bpd']):.4f}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
