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
  on the CPU.
- Several GPUs: one process per GPU under ``torchrun``
  (``python -m torch.distributed.run --nproc_per_node N -m
  humanliff_tpu_torch.cli.diff_train ...``), where JAX runs one process over
  all devices. ``--batch_size`` is the global batch: the mesh is capped to
  its largest divisor at most N, and a rank outside the capped mesh prints
  so and leaves. ``--zero_shard true`` (the default) splits Adam's moments
  and the EMAs by offset range of the flat parameter buffer over the ranks
  (ZeRO-1; JAX splits each leaf on its largest divisible axis),
  ``false`` replicates them (DDP); on one process it does nothing.
  ``--dist_backend gloo`` lets ranks share a card (NCCL needs one each).
  Rank 0 alone writes logs and checkpoints, in the one-process format.
- Data on several ranks (:func:`_batches`): a host source (a packed ``.npy``
  over 1 GB, ``--data_name imagenet``) is read by a loader of each rank,
  seeded by (seed, rank) and drawing B/W items, the reference's per-rank
  loaders, where JAX shards one loader's global batch; so the batches depend
  on the world size. The device-resident table (``--device_data``) is whole
  on every rank, where JAX shards it by example, and every rank draws the
  global batch's indices from one seed and takes its rows, as do the
  synthetic planes: these batches are the one-process ones.
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
from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import cli_mesh, is_root
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.train.stage2 import (
    Stage2Config,
    create_stage2_state,
    restore_into,
    state_payload,
    train_step,
)
from humanliff_tpu_torch.utils import logger as loglib
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
                   help="under torchrun: split Adam's moments and the EMAs over the ranks "
                        "(ZeRO-1); false replicates them (DDP). One process: does nothing")
    p.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                   help="under torchrun: the process group's backend (default nccl on "
                        "cuda, gloo on the cpu); gloo lets ranks share a card")
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


def _batches(args, device, mesh=None):
    """An iterator of batches on ``device``, and the loader to close (or None).
    With ``mesh``, two divergences from JAX, whose one loader's global batch
    is sharded: a host source (packed ``.npy`` off the device, image folder)
    gives each rank B/W items of a loader of its own seeded by (seed, rank),
    the reference's per-rank loaders; the device-resident table is whole on
    every rank (JAX shards it by example), each rank drawing the global
    batch's indices from the one seed and taking its rows. Synthetic planes
    are drawn globally and sliced too."""
    S, C, B = args.image_size, args.in_channels, args.batch_size
    rows = slice(None) if mesh is None else mesh.rows(B)
    B_local = B if mesh is None else mesh.share(B)
    rank_seed = args.seed + (0 if mesh is None else 1000 * mesh.rank)
    if args.data_name == "imagenet":
        if not os.path.isdir(args.data_dir):
            raise ValueError("--data_name imagenet needs --data_dir pointing at an image "
                             f"folder (got {args.data_dir!r})")
        from humanliff_tpu_torch.data.image_folder import load_image_data

        images = load_image_data(args.data_dir, B_local, S, class_cond=args.class_cond,
                                 seed=rank_seed)

        def image_batches():
            for b in images:
                x = torch.from_numpy(b["x"]).to(device)
                y = torch.from_numpy(b.get("y", np.zeros((B_local,), np.int32))).long()
                yield {"x": x, "x_cond": torch.zeros_like(x), "y": y.to(device)}

        return image_batches(), None
    if args.data_name != "triplane":
        raise ValueError(f"unknown --data_name {args.data_name!r}")
    if args.data_dir == "synthetic":
        rng = np.random.default_rng(args.seed)

        def synthetic():
            while True:
                x = rng.normal(scale=0.4, size=(B, S, S, C)).astype(np.float32)[rows]
                y = torch.from_numpy(rng.integers(0, 4, size=(B,))[rows])
                x = torch.from_numpy(x).to(device)
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
        batches = ({"planes": planes, **{k: torch.from_numpy(v[rows]).to(device)
                                         for k, v in b.items()}} for b in loader)
    else:
        loader = BatchLoader(len(ds), ds.item, B_local, seed=rank_seed)
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


def _save(args, step: int, state, light: bool, mesh) -> None:
    """Checkpoint ``state``: every rank gathers, rank 0 writes, all wait."""
    payload = state_payload(state, light, mesh)
    if payload is not None:
        path = ckpt.save_state(args.logdir, step, payload)
        print("saved (light: params+EMA only)" if light else "saved", path)
    del payload
    coll.barrier(mesh)


def _mesh_size(batch_size: int):
    """The mesh size for a world of N ranks: the largest divisor of the batch
    at most N (JAX diff_train.py:158-173)."""
    return lambda world: max(d for d in range(1, min(world, batch_size) + 1)
                             if batch_size % d == 0)


def main(argv=None):
    """Train; returns the state (None on a rank outside a capped mesh)."""
    setup_runtime()
    args = build_parser().parse_args(argv)
    device, mesh = cli_mesh(
        args.device, args.dist_backend, _mesh_size(args.batch_size),
        capped=f"batch_size {args.batch_size} does not divide across the ranks (raise "
               "--batch_size to a multiple of the device count to use every chip)")
    if mesh is not None and not mesh.member:
        return None
    root = is_root(mesh)
    os.makedirs(args.logdir, exist_ok=True)
    log = loglib.configure(args.logdir, ["stdout", "csv", "json"] if root else [])

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
    state = create_stage2_state(model, cfg, diffusion.num_timesteps, mesh,
                                zero=args.zero_shard)
    _resume(args, state)

    batches, loader = _batches(args, device, mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    step = state.step
    t0 = time.time()
    m_buf = []
    try:
        while step < args.total_steps:
            m_buf.append(train_step(state, model, diffusion, cfg, next(batches),
                                    generator=generator, mesh=mesh))
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
                _save(args, step, state, light, mesh)
                if os.environ.get("DIFFUSION_TRAINING_TEST"):
                    print("DIFFUSION_TRAINING_TEST set: early exit after first save")
                    return state
    finally:
        if loader is not None:
            loader.close()
    if args.skip_final_save:
        print("skip_final_save: no final checkpoint written (final state returned in-memory)")
    else:
        _save(args, step, state, args.light_final_save, mesh)
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
