"""Stage-2 diffusion training CLI (port of ``humanliff_tpu/cli/diff_train.py``;
reference scripts/image_train.py).

    python -m humanliff_tpu_torch.cli.diff_train --data_dir packed_planes.npy \\
        --batch_size 8 --microbatch 2 --lr 5e-5 --ema_rate 0.9999

``--data_dir synthetic`` trains on random planes. A packed ``.npy``
(``data/triplane_data.py::pack_subject_planes``) of at most 1 GB stays on the
card (``--device_data auto``) and the step gathers its batch by index.
``--data_name imagenet`` trains on an image folder (``--data_dir``; reference
image_train.py:54-60) through ``data/image_folder.py::load_image_data``, with
a zero x_cond, and labels from the file names with ``--class_cond true``
(zeros otherwise); set ``--in_channels``/``--out_channels`` to the images'
3. Log keys, the save policy and the ``DIFFUSION_TRAINING_TEST`` early exit
after the first periodic save (train_util.py:181-185) are the JAX CLI's.

Differences from the JAX CLI:

- ``--device`` (default ``cuda``) raises when CUDA is missing; ``cpu`` runs
  on the CPU. One device: ``--zero_shard`` is accepted and, as in JAX on one
  device, does nothing.
- Checkpoints are the port's (``train/checkpoint.py``), not orbax.
  ``--resume_npz`` continues a JAX run from its full state, exported by
  ``scripts/export_jax_weights.py --full_state``, when ``--logdir`` holds no
  checkpoint yet.
- A periodic save that lands on the final step always defers to the final
  save. In the JAX CLI a light mid-save there (``--mid_save light``) is kept
  by ``save_state``'s per-step idempotence and the full final save is lost.
- Weights start from PyTorch's initialisation seeded by ``--seed``, not
  flax's; timesteps and noise come from a ``torch.Generator``.
- Metrics stay on the card until the log interval; the JAX CLI's per-step
  readback (a wedge workaround for its remote TPU) is not ported.
- Not ported: TensorBoard logging.

Every ``--cond_type`` trains (``controlnet``, ``concat``, ``AdaGN``,
``cross_attention``, ``""``), with or without ``--use_3d_aware``;
``--use_checkpoint true`` recomputes each UNet block's activations in the
backward (``torch.utils.checkpoint``), as the JAX CLI rematerialises them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from humanliff_tpu_torch.compat.from_jax import load_stage2_npz
from humanliff_tpu_torch.models.factory import (
    channel_mult_for,
    create_model_and_diffusion,
    model_and_diffusion_defaults,
)
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.train.stage2 import (
    Stage2Config,
    create_stage2_state,
    restore_into,
    state_payload,
    train_step,
)
from humanliff_tpu_torch.utils import logger as loglib
from humanliff_tpu_torch.utils.config import device_for
from humanliff_tpu_torch.utils.runtime import setup_runtime

METRIC_KEYS = ["loss", "grad_norm"] + [f"loss_q{q}" for q in range(4)]
DEVICE_DATA_MAX_BYTES = 1 << 30


def _bool(s: str) -> bool:
    return s.lower() == "true"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("humanliff_tpu_torch diff-train")
    for k, v in model_and_diffusion_defaults().items():
        p.add_argument(f"--{k}", type=_bool if isinstance(v, bool) else type(v), default=v)
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--data_dir", type=str, default="synthetic")
    p.add_argument("--data_name", type=str, default="triplane",
                   help="'triplane': packed tri-planes (or 'synthetic' random planes); "
                        "'imagenet': an image folder")
    p.add_argument("--logdir", type=str, default="./logs/diffusion")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--microbatch", type=int, default=0)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--lr_anneal_steps", type=int, default=0)
    p.add_argument("--ema_rate", type=str, default="0.9999")
    p.add_argument("--grad_clip_norm", type=float, default=1.0,
                   help="global-norm gradient clip after the element-value clip; 0 disables")
    p.add_argument("--schedule_sampler", type=str, default="uniform")
    p.add_argument("--use_amp", type=_bool, default=True, help="bf16 autocast")
    p.add_argument("--zero_shard", type=_bool, default=True,
                   help="ZeRO-1 over the data mesh; does nothing on one device")
    p.add_argument("--device_data", type=str, default="auto", choices=("auto", "true", "false"),
                   help="keep the packed dataset on the device and gather batches by "
                        "index (auto: datasets up to 1 GB)")
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--save_interval", type=int, default=50000)
    p.add_argument("--light_final_save", type=_bool, default=False,
                   help="final checkpoint holds only {step, params, ema_params}; resuming "
                        "it restarts the optimizer")
    p.add_argument("--skip_final_save", type=_bool, default=False,
                   help="write no final checkpoint; main() returns the state")
    p.add_argument("--mid_save", type=str, default="full", choices=("full", "light"),
                   help="periodic-save payload ('light': step, params and EMA)")
    p.add_argument("--resume_npz", type=str, default=None,
                   help="a JAX run's full state (scripts/export_jax_weights.py "
                        "--full_state) to continue when --logdir has no checkpoint")
    p.add_argument("--total_steps", type=int, default=300000)
    p.add_argument("--seed", type=int, default=0)
    return p


def _batches(args, device):
    """An iterator of batches on ``device``, and the loader to close (or None)."""
    S, C, B = args.image_size, args.in_channels, args.batch_size
    if args.data_name == "imagenet":
        if not os.path.isdir(args.data_dir):
            raise ValueError("--data_name imagenet needs --data_dir pointing at an image "
                             f"folder (got {args.data_dir!r})")
        from humanliff_tpu_torch.data.image_folder import load_image_data

        images = load_image_data(args.data_dir, B, S, class_cond=args.class_cond,
                                 seed=args.seed)

        def image_batches():
            for b in images:
                x = torch.from_numpy(b["x"]).to(device)
                y = torch.from_numpy(b.get("y", np.zeros((B,), np.int32))).long()
                yield {"x": x, "x_cond": torch.zeros_like(x), "y": y.to(device)}

        return image_batches(), None
    if args.data_name != "triplane":
        raise ValueError(f"unknown --data_name {args.data_name!r}")
    if args.data_dir == "synthetic":
        rng = np.random.default_rng(args.seed)

        def synthetic():
            while True:
                x = torch.from_numpy(rng.normal(scale=0.4, size=(B, S, S, C)).astype(np.float32))
                y = torch.from_numpy(rng.integers(0, 4, size=(B,)))
                x = x.to(device)
                yield {"x": x, "x_cond": torch.zeros_like(x), "y": y.to(device)}

        return synthetic(), None

    from humanliff_tpu_torch.data.loader import BatchLoader
    from humanliff_tpu_torch.data.triplane_data import TriplaneDataset

    ds = TriplaneDataset(args.data_dir)
    on_device = args.device_data == "true" or (
        args.device_data == "auto" and ds.planes.nbytes <= DEVICE_DATA_MAX_BYTES)
    if on_device:
        planes = torch.from_numpy(ds.flat_nhwc()).to(device)
        print(f"device-resident dataset: {planes.numel() * 4 / 1e6:.0f} MB, "
              f"{planes.shape[0]} items")
        L = ds.num_layers

        def item_idx(index, rng=None):
            return {"idx": np.int64(index), "y": np.int64(index % L)}

        loader = BatchLoader(len(ds), item_idx, B, seed=args.seed)
        batches = ({"planes": planes, **{k: torch.from_numpy(v).to(device)
                                         for k, v in b.items()}} for b in loader)
    else:
        loader = BatchLoader(len(ds), ds.item, B, seed=args.seed)
        batches = ({k: torch.from_numpy(v).to(device).long() if k == "y"
                    else torch.from_numpy(v).to(device) for k, v in b.items()}
                   for b in loader)
    return batches, loader


def _resume(args, state) -> None:
    restored, start = ckpt.restore_state(args.logdir)
    if restored is not None:
        if restore_into(state, restored):
            print(f"resumed from step {start}")
        else:
            print(f"resumed from LIGHT checkpoint at step {start} "
                  "(optimizer state restarted fresh)")
    elif args.resume_npz:
        attention_ds = tuple(args.image_size // int(r)
                             for r in args.attention_resolutions.split(","))
        restore_into(state, load_stage2_npz(args.resume_npz, args.num_res_blocks,
                                            channel_mult_for(args.image_size), attention_ds))
        print(f"resumed the JAX state of {args.resume_npz} at step {state.step}")


def main(argv=None):
    setup_runtime()
    args = build_parser().parse_args(argv)
    device = device_for(args.device)
    os.makedirs(args.logdir, exist_ok=True)
    log = loglib.configure(args.logdir, ["stdout", "csv", "json"])

    torch.manual_seed(args.seed)
    with torch.device(device):
        model, diffusion = create_model_and_diffusion(
            **{k: getattr(args, k) for k in model_and_diffusion_defaults()})
    print(f"UNet params: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M")
    cfg = Stage2Config(
        lr=args.lr, weight_decay=args.weight_decay, lr_anneal_steps=args.lr_anneal_steps,
        ema_rates=tuple(float(r) for r in args.ema_rate.split(",")),
        grad_clip_norm=args.grad_clip_norm, microbatch=args.microbatch,
        use_bf16=args.use_amp, schedule_sampler=args.schedule_sampler,
        class_cond=args.class_cond,
    )
    state = create_stage2_state(model, cfg, diffusion.num_timesteps)
    _resume(args, state)

    batches, loader = _batches(args, device)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    step = state.step
    t0 = time.time()
    m_buf = []
    try:
        while step < args.total_steps:
            m_buf.append(train_step(state, model, diffusion, cfg, next(batches),
                                    generator=generator))
            step += 1
            if step % args.log_interval == 0:
                stacked = torch.stack([torch.stack([m[k] for k in METRIC_KEYS])
                                       for m in m_buf]).cpu().numpy()
                m_buf.clear()
                for k, v in zip(METRIC_KEYS, stacked.mean(axis=0)):
                    log.logkv(k, float(v))
                log.logkv("steps_per_sec", args.log_interval / (time.time() - t0))
                t0 = time.time()
                log.dumpkvs(step)
            # The unconditional step-20000 save is reference parity (train_util.py:181).
            # A save on the final step is left to the final-save policy below.
            if (step % args.save_interval == 0 or step == 20000) and step != args.total_steps:
                light = args.mid_save == "light"
                path = ckpt.save_state(args.logdir, step, state_payload(state, light))
                print("saved (light: params+EMA only)" if light else "saved", path)
                if os.environ.get("DIFFUSION_TRAINING_TEST"):
                    print("DIFFUSION_TRAINING_TEST set: early exit after first save")
                    return state
    finally:
        if loader is not None:
            loader.close()
    if args.skip_final_save:
        print("skip_final_save: no final checkpoint written (final state returned in-memory)")
    elif args.light_final_save:
        print("saved (light: params+EMA only)",
              ckpt.save_state(args.logdir, step, state_payload(state, light=True)))
    else:
        print("saved", ckpt.save_state(args.logdir, step, state_payload(state)))
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
