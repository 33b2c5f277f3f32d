"""Layered sampling CLI (port of ``humanliff_tpu/cli/diff_sample.py``; reference
scripts/triplane_sample_layered.py and triplane_sample.py).

    python -m humanliff_tpu_torch.cli.diff_sample --model_npz unet.npz \\
        --all_layers --decode --decoder_npz decoder_060000.npz

Generates layer k conditioned on layer k-1, and with ``--decode`` renders each
sample's novel views through the frozen Stage-1 decoder into PNGs and a video
and extracts a marching-cubes mesh. Layers chain in-process (``--all_layers``)
or across runs through ``--sample_npz``, the previous layer's
``samples_{layer}.npz``. Output names are the JAX CLI's: ``samples_{layer}.npz``,
``{layer}_s{i}_v{v:03d}.png``, ``{layer}_s{i}.mp4`` (or ``.avi``),
``{layer}_s{i}.ply``, ``fidelity.json`` / ``fidelity_{layer}.json`` and
``trajectory_{layer}_b{done}.npz``.

Differences from the JAX CLI:

- UNet weights come from the port's own training checkpoints
  (``--model_dir``, ``--model_step``, ``--ema_rate``: the EMA, or the raw
  params while the EMA still carries more than 10 % of its initialisation,
  the JAX CLI's burn-in rule) or from ``--model_npz`` (read by
  ``compat.from_jax.load_unet_npz``: a flax params tree with ``/``-joined
  keys, as ``scripts/export_jax_weights.py`` writes from a JAX stage-2
  checkpoint, or the port's state-dict names). The decoder comes from
  ``--decoder_npz`` (a Stage-1 ``decoder_*.npz``), not ``--stage1_ckpt``;
  JAX orbax directories are not read.
- Random numbers come from one seeded ``torch.Generator`` on the device, not
  from JAX key splits, so one ``--seed`` gives other samples than the JAX CLI.
  Parity with the JAX package is held function by function with injected
  noise (tests/test_torch_layered.py, tests/test_torch_ddim.py).
- ``--device`` (default ``cuda``) raises when CUDA is missing; ``cpu`` runs
  everything with the plain decoder.
- ``--render_bf16`` renders bf16 planes through the fp32 decoder weights (the
  fused kernel takes fp32 weights); the JAX CLI casts the weights to bf16 too.
- ``--image_scaling`` scales the intrinsics of ``--cameras_json`` cameras;
  the JAX CLI passes it only to the capture datasets.
- Not accepted: ``--auto_plan``, ``--parallel_window``, ``--parallel_tol``,
  ``--view_dataset`` (only the orbit or ``--cameras_json`` views are ported),
  ``--data_root``, ``--smpl_model_path``, ``--smplx_model_dir``; the model
  flags ``use_3d_aware`` and ``use_checkpoint`` (not ported). One device only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from humanliff_tpu_torch.compat.from_jax import decoder_state_dict, load_unet_npz
from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
from humanliff_tpu_torch.eval.fidelity import batch_fidelity, chain_fidelity_report
from humanliff_tpu_torch.mesh.io import write_ply
from humanliff_tpu_torch.models.factory import (
    channel_mult_for,
    create_model_and_diffusion,
    model_and_diffusion_defaults,
)
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder
from humanliff_tpu_torch.nerf.fastpath import build_density_grid, render_image_fast
from humanliff_tpu_torch.nerf.geometry import extract_mesh
from humanliff_tpu_torch.nerf.renderer import RenderConfig, render_image_masked
from humanliff_tpu_torch.sampling.layered import (
    LAYER_NAMES,
    generate_all_layers,
    generate_layer,
    generate_layer_progressive,
    planes_image_to_triplane,
)
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.utils.config import device_for
from humanliff_tpu_torch.utils.video import write_png, write_video

# The orbit views' box (the JAX CLI's default bounds).
ORBIT_BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)


def _bool(s: str) -> bool:
    return s.lower() == "true"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("humanliff_tpu_torch diff-sample")
    for k, v in model_and_diffusion_defaults().items():
        p.add_argument(f"--{k}", type=_bool if isinstance(v, bool) else type(v), default=v)
    weights = p.add_mutually_exclusive_group(required=True)
    weights.add_argument("--model_dir", type=str, default=None,
                         help="a training run's checkpoint directory (diff_train --logdir)")
    weights.add_argument("--model_npz", type=str, default=None,
                         help="UNet weights (EMA weights when exported from a JAX checkpoint)")
    p.add_argument("--model_step", type=int, default=None,
                   help="--model_dir's step (default: the latest)")
    p.add_argument("--ema_rate", type=str, default="0.9999")
    p.add_argument("--decoder_npz", type=str, default=None,
                   help="Stage-1 decoder weights (decoder_*.npz); needed by --decode")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out_dir", type=str, default="./samples")
    p.add_argument("--num_samples", type=int, default=25)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--layer_idx", type=int, default=0)
    p.add_argument("--all_layers", action="store_true")
    p.add_argument("--sample_npz", type=str, default=None,
                   help="previous layer's samples npz (x_cond)")
    p.add_argument("--use_ddim", type=_bool, default=False)
    p.add_argument("--decode", action="store_true",
                   help="render novel views + mesh with the Stage-1 decoder")
    p.add_argument("--cameras_json", type=str, default=None,
                   help="use this cameras.json instead of the procedural orbit")
    p.add_argument("--image_scaling", type=float, default=1.0)
    p.add_argument("--num_views", type=int, default=40)
    p.add_argument("--render_size", type=int, default=512)
    p.add_argument("--mesh_resolution", type=int, default=512)
    p.add_argument("--render_bf16", type=_bool, default=True,
                   help="bf16 planes and decoder inputs")
    p.add_argument("--fast_render", type=_bool, default=True,
                   help="density-grid coarse pass + empty-ray termination "
                        "(nerf/fastpath.py); exact fine pass")
    p.add_argument("--grid_resolution", type=int, default=128)
    p.add_argument("--early_term_eps", type=float, default=1e-2,
                   help="fast_render: terminate rays whose grid-estimated "
                        "accumulated alpha stays at or below this")
    p.add_argument("--report_fidelity", action="store_true",
                   help="change fraction and outside-region PSNR of each layer "
                        "against its conditioning (eval/fidelity.py)")
    p.add_argument("--fidelity_threshold", type=float, default=0.1)
    p.add_argument("--dump_trajectory", type=int, default=0, metavar="N",
                   help="record pred_xstart every N denoising steps to "
                        "trajectory_{layer}_b{done}.npz (0 = off)")
    p.add_argument("--seed", type=int, default=0)
    return p


def load_train_weights(model_dir: str, step, rate: str):
    """The UNet state dict to sample from a training checkpoint: the EMA at
    ``rate``, or the raw params while rate^step > 0.1 (the EMA starts at the
    random init and still carries that share of it)."""
    restored, step = ckpt.restore_state(model_dir, step=step)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {model_dir}")
    ema, rate_used = ckpt.get_ema(restored, rate)
    init_w = float(rate_used) ** max(int(step), 0)
    if init_w > 0.1:
        print(f"WARNING: EMA({rate_used}) at step {step} still carries {init_w:.1%} of the "
              "random init; sampling RAW params instead (use a faster --ema_rate for "
              "short trainings)")
        return ckpt.get_field(restored, "params")
    print(f"loaded EMA({rate_used}) weights from step {step}")
    return ema


def _load_model(args, device):
    cfg = {k: getattr(args, k) for k in model_and_diffusion_defaults()}
    with torch.device(device):
        model, diffusion = create_model_and_diffusion(**cfg)
    if args.model_dir is not None:
        sd = load_train_weights(args.model_dir, args.model_step, args.ema_rate)
    else:
        attention_ds = tuple(args.image_size // int(r)
                             for r in args.attention_resolutions.split(","))
        sd = load_unet_npz(args.model_npz, args.num_res_blocks,
                           channel_mult_for(args.image_size), attention_ds)
    model.load_state_dict(sd, strict=True)
    model.eval()
    if device.type == "cuda":  # bf16 weights, channels_last: the main path's layout
        model.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    return model, diffusion


def _load_decoder(args, device) -> NeRFDecoder:
    if args.decoder_npz is None:
        raise ValueError("--decode needs --decoder_npz")
    decoder = NeRFDecoder(d_in=args.in_channels)
    decoder.load_state_dict(decoder_state_dict(ckpt.load_decoder_npz(args.decoder_npz)),
                            strict=True)
    return decoder.to(device).eval()


def _decode_samples(args, decoder, samples: np.ndarray, layer_name: str, device) -> None:
    """Render each sample's views to PNGs and a video, and export its mesh
    (triplane_sample_layered.py:155-207). All views go through one render
    call: they share the box."""
    S = args.render_size
    if args.cameras_json is None:
        print("[decode] NOTE: procedural-orbit cameras and default bounds "
              "(no --cameras_json given)")
    cams = NovelViewCameras(image_size=S, cameras_json=args.cameras_json,
                            image_scaling=args.image_scaling)
    items = [cams.rays(v, ORBIT_BOUNDS) for v in range(args.num_views)]
    rays = {k: np.concatenate([it[k] for it in items])
            for k in ("rays_o", "rays_d", "near", "far", "ray_mask")}
    dtype = torch.bfloat16 if args.render_bf16 else torch.float32
    cfg = RenderConfig(n_samples=128, n_importance=128, perturb=False, density_noise=False)
    render_args = (rays["rays_o"], rays["rays_d"], rays["near"], rays["far"],
                   rays["ray_mask"], ORBIT_BOUNDS, cfg)

    for si, sample in enumerate(samples):
        planes = planes_image_to_triplane(
            torch.from_numpy(np.asarray(sample)).to(device=device, dtype=dtype)).contiguous()
        t0 = time.perf_counter()
        if args.fast_render:
            grid = build_density_grid(decoder, planes, ORBIT_BOUNDS,
                                      resolution=args.grid_resolution)
            out = render_image_fast(decoder, planes, grid, *render_args, outputs=("rgb",),
                                    early_term_eps=args.early_term_eps)
        else:
            out = render_image_masked(decoder, planes, *render_args, outputs=("rgb",))
        frames = (out["rgb"].clamp(0, 1) * 255).to(torch.uint8).reshape(-1, S, S, 3)
        frames = list(frames.cpu().numpy())
        render_s = time.perf_counter() - t0
        for v, img in enumerate(frames):
            write_png(os.path.join(args.out_dir, f"{layer_name}_s{si}_v{v:03d}.png"), img)
        write_video(os.path.join(args.out_dir, f"{layer_name}_s{si}.mp4"), frames, fps=20)

        t0 = time.perf_counter()
        verts, tris = extract_mesh(decoder, planes, ORBIT_BOUNDS,
                                   resolution=args.mesh_resolution)
        mesh_s = time.perf_counter() - t0
        write_ply(os.path.join(args.out_dir, f"{layer_name}_s{si}.ply"), verts, tris)
        print(f"decoded sample {si}: {args.num_views} views in {render_s:.3f} s "
              f"({'fast' if args.fast_render else 'exact'} tier), mesh "
              f"{len(verts)} verts / {len(tris)} tris at {args.mesh_resolution}^3 "
              f"in {mesh_s:.3f} s")


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
    print("wrote", path)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = device_for(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    model, diffusion = _load_model(args, device)
    decoder = _load_decoder(args, device) if args.decode else None
    generator = torch.Generator(device=device).manual_seed(args.seed)
    S, C = args.image_size, args.in_channels

    if args.all_layers:
        all_samples = {name: [] for name in LAYER_NAMES}
        done = 0
        for B in [args.batch_size] * math.ceil(args.num_samples / args.batch_size):
            layers = generate_all_layers(model, diffusion, generator=generator, batch_size=B,
                                         image_size=S, channels=C, device=device,
                                         use_ddim=args.use_ddim)
            for name, x in layers.items():
                all_samples[name].append(x.cpu().numpy())
            done += B
            print(f"sampled {min(done, args.num_samples)}/{args.num_samples}")
        stacked = {name: np.concatenate(chunks)[: args.num_samples]
                   for name, chunks in all_samples.items()}
        for name, arr in stacked.items():
            path = os.path.join(args.out_dir, f"samples_{name}.npz")
            ckpt.save_samples_npz(path, arr)
            print("wrote", path)
            if args.decode:
                _decode_samples(args, decoder, arr, name, device)
        if args.report_fidelity:
            report = chain_fidelity_report(stacked, args.fidelity_threshold)
            for pair, m in report.items():
                print(f"[fidelity] {pair}: {m}")
            _write_json(os.path.join(args.out_dir, "fidelity.json"), report)
        return

    prev = None
    if args.sample_npz:
        prev = ckpt.load_samples_npz(args.sample_npz).astype(np.float32)
        if prev.shape[0] < args.num_samples:
            raise ValueError(
                f"--sample_npz has {prev.shape[0]} previous-layer samples but "
                f"--num_samples={args.num_samples}; the layered chain needs a "
                "1:1 correspondence (triplane_sample_layered.py:131-132)")
    name = LAYER_NAMES[args.layer_idx]
    outs, done = [], 0
    while done < args.num_samples:
        # Each batch conditions on its own slice of the previous layer's samples.
        xc = None
        if prev is not None:
            xc = prev[done: done + args.batch_size]
            if xc.shape[0] < args.batch_size:  # ragged tail: pad (trimmed below)
                xc = np.concatenate([xc, np.repeat(xc[-1:], args.batch_size - xc.shape[0], 0)])
            xc = torch.from_numpy(xc).to(device)
        kw = dict(generator=generator, batch_size=args.batch_size, image_size=S, channels=C,
                  use_ddim=args.use_ddim, device=device)
        if args.dump_trajectory:
            samples, traj = generate_layer_progressive(
                model, diffusion, args.layer_idx, xc, record_every=args.dump_trajectory, **kw)
            tpath = os.path.join(args.out_dir, f"trajectory_{name}_b{done}.npz")
            np.savez_compressed(tpath, t=np.asarray([t for t, _ in traj], np.int32),
                                pred_xstart=np.stack([p for _, p in traj]))
            print("wrote", tpath)
        else:
            samples = generate_layer(model, diffusion, args.layer_idx, xc, **kw)
        outs.append(samples.cpu().numpy())
        done += args.batch_size
        print(f"sampled {done}/{args.num_samples}")
    arr = np.concatenate(outs)[: args.num_samples]
    path = os.path.join(args.out_dir, f"samples_{name}.npz")
    ckpt.save_samples_npz(path, arr)
    print("wrote", path)
    if args.report_fidelity and prev is not None:
        report = batch_fidelity(arr, prev[: arr.shape[0]], args.fidelity_threshold)
        print(f"[fidelity] prev->{name}: {report}")
        _write_json(os.path.join(args.out_dir, f"fidelity_{name}.json"), report)
    if args.decode:
        _decode_samples(args, decoder, arr, name, device)


if __name__ == "__main__":
    main(sys.argv[1:])
