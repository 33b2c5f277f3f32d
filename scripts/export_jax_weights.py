#!/usr/bin/env python3
"""Export the sampling weights of a JAX stage-2 checkpoint to one npz that the
PyTorch port reads (``humanliff_tpu_torch.cli.diff_sample --model_npz``).

    python3 scripts/export_jax_weights.py --model_dir runs/.../train \\
        [--model_step N] [--ema_rate 0.9999] --out unet_ema.npz

It restores the orbax state and picks the weights the JAX sampling CLI would
sample with (``humanliff_tpu.cli.diff_sample._load_ema_params``): the EMA at
``--ema_rate``, or the raw params while the EMA still carries more than 10 %
of its random init. The npz holds the flax params tree with ``/``-joined keys
(``params/enc_in_conv/kernel``), uncompressed. This script imports JAX and the
JAX package on purpose: it is the bridge for weights trained there.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def flatten_params(tree) -> dict:
    """``{"params/a/kernel": array}`` of a nested param dict."""
    import jax

    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))

    return {"/".join(key(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_dir", required=True, help="stage-2 checkpoint directory")
    ap.add_argument("--model_step", type=int, default=None, help="default: the latest")
    ap.add_argument("--ema_rate", default="0.9999")
    ap.add_argument("--out", required=True, help="the npz to write")
    args = ap.parse_args(argv)

    from humanliff_tpu.cli.diff_sample import _load_ema_params

    params = _load_ema_params(args)
    flat = flatten_params(params)
    np.savez(args.out, **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {args.out}: {len(flat)} arrays, {n:,} parameters")
    return args.out


if __name__ == "__main__":
    main()
