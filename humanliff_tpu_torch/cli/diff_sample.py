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
- Several GPUs: one process per GPU under ``torchrun`` (``python -m
  torch.distributed.run --nproc_per_node N -m
  humanliff_tpu_torch.cli.diff_sample ...``), where JAX runs one process over
  all devices. ``--parallel_window`` splits each window's slots over the
  ranks (the window must divide over them); without a window rank 0
  generates and broadcasts the layers, so every rank decodes the same
  planes. ``--decode`` of views that share a box goes through
  ``nerf/sharded.py::render_views_sharded`` (the exact tier, as in JAX, even
  with ``--fast_render``), its tiles split over the ranks; other views, the
  mesh and every file are rank 0's. ``--dist_backend gloo`` lets ranks share
  a card.

``--all_layers --auto_plan true`` splits ``--num_samples`` into the chain
batches of ``sampling/layered.py::plan_workload`` (its table of measured
chain costs) instead of ``--batch_size`` each. ``--parallel_window W`` samples
each layer's ancestral chain by sliding-window Picard iteration
(``sampling/parallel.py``; accepted guesses within ``--parallel_tol``); a
window means no ``--auto_plan`` plan (the plan's costs are the sequential
chain's), as in the JAX CLI, and it cannot be combined with ``--use_ddim``.
``--dump_trajectory`` records the sequential chain, as in the JAX CLI. Every
model the factory builds samples: ``--cond_type``, ``--use_3d_aware``;
``--use_checkpoint`` does nothing without gradients.

``--view_dataset synbody`` or ``tightcap`` decodes the capture's novel views
145 onward (``--data_root``; the SMPL-X models of ``--smplx_model_dir``, or
the SMPL model ``--smpl_model_path``): full-image rays against the posed
bounds. TightCap renders in canonical space through the inverse-LBS deform of
each view's SMPL fit, its mesh in the big pose's bounds; the body model and
its arrays on the device are loaded once per path (``load_body_model``'s
cache).
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

from humanliff_tpu_torch.bodymodel.canonical import make_eval_deform_fn
from humanliff_tpu_torch.bodymodel.smpl import find_smplx_model, load_body_model
from humanliff_tpu_torch.cli.recon_test import deform_args
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict, load_unet_npz
from humanliff_tpu_torch.data.view_datasets import (
    NovelViewCameras,
    SynBodyViewDataset,
    TightCapViewDataset,
)
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
from humanliff_tpu_torch.nerf.sharded import render_views_sharded
from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import cli_mesh, is_root
from humanliff_tpu_torch.sampling.layered import (
    LAYER_NAMES,
    generate_all_layers,
    generate_layer,
    generate_layer_progressive,
    plan_workload,
    planes_image_to_triplane,
)
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.utils.runtime import setup_runtime
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
    p.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                   help="under torchrun: the process group's backend (default nccl on "
                        "cuda, gloo on the cpu); gloo lets ranks share a card")
    p.add_argument("--out_dir", type=str, default="./samples")
    p.add_argument("--num_samples", type=int, default=25)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--layer_idx", type=int, default=0)
    p.add_argument("--all_layers", action="store_true")
    p.add_argument("--auto_plan", type=_bool, default=False,
                   help="all_layers mode: ignore --batch_size and split --num_samples "
                        "by the measured-cost plan (sampling/layered.py::plan_workload)")
    p.add_argument("--sample_npz", type=str, default=None,
                   help="previous layer's samples npz (x_cond)")
    p.add_argument("--use_ddim", type=_bool, default=False)
    p.add_argument("--parallel_window", type=int, default=0,
                   help="sliding-window Picard sampling: timesteps per batched UNet call "
                        "(0 = the sequential chain; sampling/parallel.py)")
    p.add_argument("--parallel_tol", type=float, default=5e-3,
                   help="--parallel_window: mean-abs residual at or below which a "
                        "guessed step is accepted (0 = the sequential result)")
    p.add_argument("--decode", action="store_true",
                   help="render novel views + mesh with the Stage-1 decoder")
    p.add_argument("--view_dataset", type=str, default="orbit",
                   choices=("orbit", "synbody", "tightcap"),
                   help="views and bounds of the decode: a capture's novel views "
                        "(synbody, tightcap) or the procedural orbit")
    p.add_argument("--data_root", type=str, default=None,
                   help="capture root for --view_dataset synbody/tightcap")
    p.add_argument("--smpl_model_path", type=str, default="assets/SMPL_NEUTRAL.pkl")
    p.add_argument("--smplx_model_dir", type=str, default="assets",
                   help="directory holding SMPLX_{GENDER}.npz/.pkl for --view_dataset synbody")
    p.add_argument("--cameras_json", type=str, default=None,
                   help="orbit views: use this cameras.json instead of the procedural orbit")
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


def _load_model(args, device, bf16: bool = True):
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
    if device.type == "cuda":  # channels_last (and bf16 weights): the main path's layout
        model.to(dtype=torch.bfloat16 if bf16 else torch.float32,
                 memory_format=torch.channels_last)
    return model, diffusion


def _load_decoder(args, device) -> NeRFDecoder:
    if args.decoder_npz is None:
        raise ValueError("--decode needs --decoder_npz")
    decoder = NeRFDecoder(d_in=args.in_channels)
    decoder.load_state_dict(decoder_state_dict(ckpt.load_decoder_npz(args.decoder_npz)),
                            strict=True)
    return decoder.to(device).eval()


def _view_items(args, layer_idx: int):
    """The decode's view items and their deform (None in world space): the
    orbit's (or ``--cameras_json``'s) views, or a capture's novel views 145
    onward (JAX diff_sample.py:133-182)."""
    if args.view_dataset == "orbit":
        if args.cameras_json is None:
            print("[decode] NOTE: procedural-orbit cameras and default bounds "
                  "(no --cameras_json given)")
        cams = NovelViewCameras(image_size=args.render_size, cameras_json=args.cameras_json,
                                image_scaling=args.image_scaling)
        return [dict(cams.rays(v, ORBIT_BOUNDS), box_warp=ORBIT_BOUNDS)
                for v in range(args.num_views)], None
    views = list(range(145, 145 + args.num_views))
    deform_fn = None
    if args.view_dataset == "synbody":
        models = {g: load_body_model(find_smplx_model(args.smplx_model_dir, g))
                  for g in ("male", "female", "neutral")}
        ds = SynBodyViewDataset(data_root=args.data_root, body_models=models,
                                image_scaling=args.image_scaling, layer_idx=layer_idx,
                                output_views=views)
    else:
        body = load_body_model(args.smpl_model_path)
        ds = TightCapViewDataset(data_root=args.data_root, body_model=body,
                                 image_scaling=args.image_scaling, layer_idx=layer_idx,
                                 output_views=views)
        deform_fn = make_eval_deform_fn(body)
    return [ds.item(i) for i in range(min(args.num_views, len(ds)))], deform_fn


def _decode_samples(args, decoder, samples: np.ndarray, layer_name: str, device,
                    mesh=None) -> None:
    """Render each sample's views to PNGs and a video, and export its mesh in
    the first view's box (triplane_sample_layered.py:155-207). Views that
    share the box and need no deform go through one render call; canonical
    views render one by one, each with its own deform arguments. With
    ``mesh``, views that share the box render with their tiles split over
    the ranks (canonical ones too); else rank 0 renders alone. Rank 0
    writes."""
    items, deform_fn = _view_items(args, LAYER_NAMES.index(layer_name))
    shapes = [(int(it["hw"][0]), int(it["hw"][1])) for it in items]
    box = np.asarray(items[0]["box_warp"], np.float32)
    same_box = all(np.array_equal(np.asarray(it["box_warp"], np.float32), box)
                   for it in items)
    sharded = mesh is not None and same_box
    if mesh is not None and not sharded and not is_root(mesh):
        return
    one_call = deform_fn is None and same_box
    groups = ([] if sharded else
              [{k: np.concatenate([it[k] for it in items])
                for k in ("rays_o", "rays_d", "near", "far", "ray_mask")}] if one_call
              else items)
    dtype = torch.bfloat16 if args.render_bf16 else torch.float32
    cfg = RenderConfig(n_samples=128, n_importance=128, perturb=False, density_noise=False)

    for si, sample in enumerate(samples):
        planes = planes_image_to_triplane(
            torch.from_numpy(np.asarray(sample)).to(device=device, dtype=dtype)).contiguous()
        t0 = time.perf_counter()
        grid = (build_density_grid(decoder, planes, box, resolution=args.grid_resolution)
                if args.fast_render and not sharded else None)
        rgb = []
        if sharded:
            outs = render_views_sharded(
                decoder, planes, items, cfg, mesh, deform_fn=deform_fn,
                deform_args_fn=None if deform_fn is None else deform_args)
            rgb = [(o["rgb"].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy() for o in outs]
            if not is_root(mesh):
                continue
        for g in groups:
            render_args = (g["rays_o"], g["rays_d"], g["near"], g["far"], g["ray_mask"],
                           np.asarray(g.get("box_warp", box), np.float32), cfg)
            dargs = None if deform_fn is None else deform_args(g)
            if grid is not None:
                out = render_image_fast(decoder, planes, grid, *render_args, outputs=("rgb",),
                                        early_term_eps=args.early_term_eps,
                                        deform_fn=deform_fn, deform_args=dargs)
            else:
                out = render_image_masked(decoder, planes, *render_args, outputs=("rgb",),
                                          deform_fn=deform_fn, deform_args=dargs)
            rgb.append((out["rgb"].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
        rgb = np.concatenate(rgb)
        frames = [f.reshape(H, W, 3) for f, (H, W) in
                  zip(np.split(rgb, np.cumsum([H * W for H, W in shapes])[:-1]), shapes)]
        render_s = time.perf_counter() - t0
        for v, img in enumerate(frames):
            write_png(os.path.join(args.out_dir, f"{layer_name}_s{si}_v{v:03d}.png"), img)
        write_video(os.path.join(args.out_dir, f"{layer_name}_s{si}.mp4"), frames, fps=20)

        t0 = time.perf_counter()
        verts, tris = extract_mesh(decoder, planes, box, resolution=args.mesh_resolution)
        mesh_s = time.perf_counter() - t0
        write_ply(os.path.join(args.out_dir, f"{layer_name}_s{si}.ply"), verts, tris)
        tier = "fast" if grid is not None else "exact"
        print(f"decoded sample {si}: {len(frames)} views in {render_s:.3f} s "
              f"({tier} tier{', sharded' if sharded else ''}), mesh "
              f"{len(verts)} verts / {len(tris)} tris at {args.mesh_resolution}^3 "
              f"in {mesh_s:.3f} s")


def chain_batches(args) -> list:
    """The batch size of each ``--all_layers`` chain: ``plan_workload``'s plan
    with ``--auto_plan`` and no ``--parallel_window`` (JAX
    diff_sample.py:366-375), else ``--batch_size`` for every chain."""
    if args.auto_plan and not args.parallel_window:
        plan = plan_workload(args.num_samples)
        print(f"[plan] mixed-batch plan for {args.num_samples}: {plan}")
        return plan
    return [args.batch_size] * math.ceil(args.num_samples / args.batch_size)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
    print("wrote", path)


def _on_every_rank(mesh, parallel_mesh, make, shapes: dict) -> dict:
    """``make()``'s dict of float32 tensors on every rank: each rank's own
    where a Picard window splits over the ranks (all compute alike), else
    rank 0's, broadcast into buffers of ``shapes``."""
    if mesh is None or parallel_mesh is not None:
        return make()
    out = ({k: v.contiguous() for k, v in make().items()} if is_root(mesh)
           else {k: torch.empty(s, device=mesh.device) for k, s in shapes.items()})
    for v in out.values():
        coll.broadcast_(v, 0, mesh)
    return out


def main(argv=None) -> None:
    setup_runtime()
    args = build_parser().parse_args(argv)
    device, mesh = cli_mesh(args.device, args.dist_backend)
    root = is_root(mesh)
    parallel_mesh = mesh if args.parallel_window else None
    os.makedirs(args.out_dir, exist_ok=True)
    model, diffusion = _load_model(args, device)
    decoder = _load_decoder(args, device) if args.decode else None
    generator = torch.Generator(device=device).manual_seed(args.seed)
    S, C = args.image_size, args.in_channels

    if args.all_layers:
        all_samples = {name: [] for name in LAYER_NAMES}
        done = 0
        for B in chain_batches(args):
            layers = _on_every_rank(
                mesh, parallel_mesh,
                lambda B=B: generate_all_layers(
                    model, diffusion, generator=generator, batch_size=B, image_size=S,
                    channels=C, device=device, use_ddim=args.use_ddim,
                    parallel_window=args.parallel_window, parallel_tol=args.parallel_tol,
                    parallel_mesh=parallel_mesh),
                {name: (B, S, S, C) for name in LAYER_NAMES})
            for name, x in layers.items():
                all_samples[name].append(x.cpu().numpy())
            done += B
            print(f"sampled {min(done, args.num_samples)}/{args.num_samples}")
        stacked = {name: np.concatenate(chunks)[: args.num_samples]
                   for name, chunks in all_samples.items()}
        for name, arr in stacked.items():
            if root:
                path = os.path.join(args.out_dir, f"samples_{name}.npz")
                ckpt.save_samples_npz(path, arr)
                print("wrote", path)
            if args.decode:
                _decode_samples(args, decoder, arr, name, device, mesh)
        if args.report_fidelity and root:
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
        shape = (args.batch_size, S, S, C)
        if args.dump_trajectory:
            def progressive(xc=xc, done=done):
                samples, traj = generate_layer_progressive(
                    model, diffusion, args.layer_idx, xc, record_every=args.dump_trajectory,
                    **kw)
                tpath = os.path.join(args.out_dir, f"trajectory_{name}_b{done}.npz")
                np.savez_compressed(tpath, t=np.asarray([t for t, _ in traj], np.int32),
                                    pred_xstart=np.stack([p for _, p in traj]))
                print("wrote", tpath)
                return {"x": samples}

            samples = _on_every_rank(mesh, None, progressive, {"x": shape})["x"]
        else:
            samples = _on_every_rank(
                mesh, parallel_mesh,
                lambda xc=xc: {"x": generate_layer(
                    model, diffusion, args.layer_idx, xc, parallel_window=args.parallel_window,
                    parallel_tol=args.parallel_tol, parallel_mesh=parallel_mesh, **kw)},
                {"x": shape})["x"]
        outs.append(samples.cpu().numpy())
        done += args.batch_size
        print(f"sampled {done}/{args.num_samples}")
    arr = np.concatenate(outs)[: args.num_samples]
    if root:
        path = os.path.join(args.out_dir, f"samples_{name}.npz")
        ckpt.save_samples_npz(path, arr)
        print("wrote", path)
    if args.report_fidelity and prev is not None and root:
        report = batch_fidelity(arr, prev[: arr.shape[0]], args.fidelity_threshold)
        print(f"[fidelity] prev->{name}: {report}")
        _write_json(os.path.join(args.out_dir, f"fidelity_{name}.json"), report)
    if args.decode:
        _decode_samples(args, decoder, arr, name, device, mesh)


if __name__ == "__main__":
    main(sys.argv[1:])
