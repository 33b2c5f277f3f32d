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

    python3 scripts/export_jax_weights.py --model_dir runs/.../train \
        --full_state --out stage2_state.npz

writes the whole Stage-2 train state instead (``full_state_arrays``): params,
the AdamW moments and count, every EMA and the loss-aware sampler's state,
which ``humanliff_tpu_torch.cli.diff_train --resume_npz`` continues from.
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


def _plain(tree):
    """Named tuples (optax states) as dicts, tuples as lists, recursively."""
    if hasattr(tree, "_asdict"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def full_state_arrays(state) -> dict:
    """A JAX ``Stage2State`` (live, or as orbax restores it without a target)
    as flat arrays: ``step``, ``count``, ``params/...``, ``mu/...``,
    ``nu/...``, ``ema/<rate>/...`` and, where present, ``sampler/history``
    and ``sampler/counts`` (the keys of
    ``humanliff_tpu_torch.compat.from_jax.stage2_state_from_arrays``)."""
    import jax

    if not isinstance(state, dict):
        state = {f: getattr(state, f) for f in
                 ("step", "params", "opt_state", "ema_params", "sampler_state")}
    state = _plain(jax.device_get(state))
    # make_stage2_optimizer's chain: the clips, then adamw = (scale_by_adam,
    # add_decayed_weights, scale_by_schedule).
    adam, _, schedule = state["opt_state"][-1]
    if int(adam["count"]) != int(schedule["count"]):
        raise ValueError(f"Adam count {adam['count']} != schedule count {schedule['count']}")
    out = {"step": np.asarray(state["step"]), "count": np.asarray(adam["count"])}
    for prefix, tree in [("params", state["params"]), ("mu", adam["mu"]), ("nu", adam["nu"])]:
        out.update({f"{prefix}/{k}": v for k, v in flatten_params(tree).items()})
    for rate, tree in state["ema_params"].items():
        out.update({f"ema/{rate}/{k}": v for k, v in flatten_params(tree).items()})
    if state.get("sampler_state") is not None:
        out.update({f"sampler/{k}": np.asarray(v) for k, v in state["sampler_state"].items()})
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_dir", required=True, help="stage-2 checkpoint directory")
    ap.add_argument("--model_step", type=int, default=None, help="default: the latest")
    ap.add_argument("--ema_rate", default="0.9999")
    ap.add_argument("--out", required=True, help="the npz to write")
    ap.add_argument("--full_state", action="store_true",
                    help="the whole train state, not the sampling weights")
    args = ap.parse_args(argv)

    if args.full_state:
        from humanliff_tpu.train import checkpoint as ckpt

        restored, step = ckpt.restore_state(args.model_dir, step=args.model_step)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {args.model_dir}")
        flat = full_state_arrays(restored)
    else:
        from humanliff_tpu.cli.diff_sample import _load_ema_params

        flat = flatten_params(_load_ema_params(args))
    np.savez(args.out, **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {args.out}: {len(flat)} arrays, {n:,} parameters")
    return args.out


if __name__ == "__main__":
    main()
