"""Stage-2 generative-quality campaign on the pinned synthetic benchmark (port
of ``humanliff_tpu/cli/quality_stage2.py``).

    python -m humanliff_tpu_torch.cli.quality_stage2 --out_dir runs/quality_torch

The Stage-1 campaign (``cli/quality_eval.py``) proves reconstruction quality;
this one runs the generative half on the trained weights, the reference flow
end to end (README.md:104-167), Stage 1 -> Stage 2 -> decode in one program:

1. EXPORT: the Stage-1 campaign checkpoint's fitted tri-planes (the port's,
   under ``{out_dir}/train``) become per-subject artifacts
   ``{work}/planes/campaign{i:04d}_{step:06d}.npz``. Exports that outlive the
   latest checkpoint (it was pruned) are kept: ``recon_refit`` rebuilds a
   consistent checkpoint from them and the decoder sidecar.
2. FINE-TUNE: ``--ft_subjects`` extra synthetic subjects fitted against the
   frozen campaign decoder through ``recon_ft`` (run_nerf_batch_ft.py flow,
   batched), growing the diffusion training set.
3. PACK + TRAIN: all subjects but the last pack into the memmap dataset; the
   flagship ControlNet UNet trains on its (x, x_cond, y) layer triples through
   ``diff_train``; the last subject is held out entirely.
4. WEIGHTS: the final state in memory when training just ran, else the
   latest checkpoint; the EMA, or the raw params while the EMA still carries
   more than 10 % of its random init (the burn-in guard).
5. SAMPLE: the 4-layer chain under ``sampling/layered.py::generate_workload``'s
   mixed-batch plan, with a weights fingerprint and the chain's plane
   fidelity.
6. SCORE: the held-out and train denoise loss per layer
   (``eval/fidelity.py::heldout_denoise_loss``, deterministic t-grid), the
   nearest-GT plane PSNR per layer, and the image-space chain consistency of
   consecutive generated layers rendered through the frozen Stage-1 decoder
   of the exports' decoder sidecar (``decoded_fidelity``).
7. REPORT: ``{work}/STAGE2.md`` and ``{work}/stage2_metrics.json`` (the JAX
   CLI's keys, written last); any failure writes a labelled failure report
   instead.

Every leg skips itself when its artifact exists, so the campaign resumes
after an interruption; ``--report_only`` rebuilds the report from the
metrics.

Differences from the JAX CLI:

- ``--out_dir`` defaults to ``runs/quality_torch``: under the JAX default,
  ``runs/quality``, a port run would write over the JAX campaign's committed
  files, and its orbax checkpoints are not read here anyway (a JAX Stage-1
  state comes across through ``scripts/export_jax_weights.py --stage1``, or
  ``recon_refit`` rebuilds one from plane exports and a decoder sidecar).
- Several GPUs: under ``torchrun`` the fine-tune leg is ``recon_ft`` over all
  the ranks (the rank count must divide ``--ft_subjects``) and the diffusion
  leg ``diff_train`` (its mesh capped to the largest divisor of
  ``--diff_batch_size``, JAX's rule); rank 0 alone exports, packs, samples,
  scores and writes the report, and the other ranks leave after training.
  Rank 0 scores the final diffusion checkpoint (under ZeRO no rank holds the
  whole EMA), so ``--final_save none`` is refused there.
  ``--report_only`` is one process's. The diffusion leg trains without
  activation checkpointing. The JAX
  campaign passes ``--use_checkpoint true`` because the flagship at batch 2
  does not fit a 16 GB TPU without it; on an 80 GB H100 it peaks at about
  21 GB without, and checkpointing would double the step's time for nothing
  (PERF.md, the family phase). The numbers are the same either way.
- ``--device`` (default ``cuda``, which raises where CUDA is missing; ``cpu``
  on request). Random numbers come from seeded ``torch.Generator``s (sampling
  ``--seed`` + 3, scoring ``--seed`` + 7), not JAX keys. The sampling and
  scoring UNet runs in bf16 on CUDA, as ``diff_sample`` runs it. PNGs are
  written by the port's stdlib writer.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import re
import sys
from typing import Optional

import numpy as np
import torch

from humanliff_tpu_torch.nerf.renderer import render_image_masked
from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import cli_mesh, is_root
from humanliff_tpu_torch.sampling.layered import LAYER_NAMES
from humanliff_tpu_torch.utils.config import DECODER_CHANNELS, decoder_channels
from humanliff_tpu_torch.utils.runtime import setup_runtime

CAMPAIGN_COMMAND = "python -m humanliff_tpu_torch.cli.quality_stage2"


def build_parser():
    p = argparse.ArgumentParser("humanliff_tpu_torch quality-stage2")
    p.add_argument("--out_dir", type=str, default="runs/quality_torch",
                   help="Stage-1 campaign dir (quality_eval.py --out_dir)")
    p.add_argument("--work_dir", type=str, default=None, help="default: {out_dir}/stage2")
    # Stage-1 campaign geometry (must match quality_eval.py's pinned values).
    p.add_argument("--num_instance", type=int, default=2)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--triplane_dim", type=int, default=256)
    p.add_argument("--triplane_ch", type=decoder_channels, default=DECODER_CHANNELS)
    p.add_argument("--n_samples", type=int, default=128)
    p.add_argument("--n_importance", type=int, default=128)
    # Fine-tune leg.
    p.add_argument("--ft_subjects", type=int, default=3,
                   help="extra synthetic subjects fitted with the frozen decoder "
                        "(0 skips the leg)")
    p.add_argument("--ft_steps", type=int, default=1500)
    p.add_argument("--ft_batch_size", type=int, default=1)
    p.add_argument("--ft_n_rand", type=int, default=2048)
    # Diffusion leg (flagship UNet geometry by default; overridable so the
    # campaign runs at tiny dims on the CPU).
    p.add_argument("--num_channels", type=int, default=192)
    p.add_argument("--num_res_blocks", type=int, default=3)
    p.add_argument("--attention_resolutions", type=str, default="32,16,8")
    p.add_argument("--diff_steps", type=int, default=6000)
    p.add_argument("--diff_batch_size", type=int, default=2)
    p.add_argument("--diff_lr", type=float, default=1e-4)
    p.add_argument("--save_interval", type=int, default=2000)
    p.add_argument("--light_final_save", type=str, default="false", choices=("true", "false"),
                   help="forwarded to diff_train: the final diffusion checkpoint keeps "
                        "only params + EMA (sampling and scoring need only the EMA)")
    p.add_argument("--final_save", type=str, default=None, choices=("full", "light", "none"),
                   help="final diffusion checkpoint policy: 'none' skips the save and "
                        "samples/scores the in-memory final state. Default derives "
                        "from --light_final_save.")
    # 0.999 (half-life ~700 steps), not the reference's 0.9999: the EMA starts
    # at the random init, and at the campaign's ~6k steps a 0.9999 EMA still
    # carries 0.9999^6000 ~ 55 % of it.
    p.add_argument("--ema_rate", type=str, default="0.999")
    p.add_argument("--mid_save", type=str, default="full", choices=("full", "light"),
                   help="periodic diffusion-save payload (forwarded to diff_train): "
                        "'light' keeps params + EMA; resume restarts Adam fresh")
    # Sampling / scoring leg. Batch sizes come from generate_workload's plan
    # over DEFAULT_CHAIN_COSTS: there is no user batch knob.
    p.add_argument("--num_samples", type=int, default=8)
    p.add_argument("--respacing", type=str, default="250")
    p.add_argument("--decode_size", type=int, default=256)
    p.add_argument("--fidelity_threshold", type=float, default=0.1)
    p.add_argument("--n_eval_timesteps", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report_only", action="store_true",
                   help="rebuild STAGE2.md from an existing stage2_metrics.json "
                        "(no training, sampling or scoring)")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                   help="under torchrun: the process group's backend (default nccl on "
                        "cuda, gloo on the cpu); gloo lets ranks share a card")
    return p


def _export_campaign_planes(args, planes_dir: str):
    """Stage-1 checkpoint -> per-subject plane npz.

    Skips when the existing exports come from the current latest Stage-1
    checkpoint (the producing step is in the filename). Exports from an older
    checkpoint are stale: removed and exported again, so every downstream
    artifact traces to one checkpoint step. Exports newer than the latest
    checkpoint mean the producing checkpoint was pruned: they are the best
    surviving artifact and are kept (``recon_refit`` rebuilds a consistent
    checkpoint from them). Returns (paths, whether they were just written).
    """
    from humanliff_tpu_torch.train import checkpoint as ckpt

    paths = sorted(glob.glob(os.path.join(planes_dir, "campaign*.npz")))
    latest = ckpt.latest_step(os.path.join(args.out_dir, "train"))
    export_steps = sorted({int(m.group(1)) for p in paths
                           if (m := re.search(r"_(\d{6})\.npz$", os.path.basename(p)))})
    if paths and len(export_steps) == 1 and len(paths) == args.num_instance:
        step = export_steps[0]
        if latest is None or step >= latest:
            if latest is None or step > latest:
                print(f"[stage2] WARNING: exports at step {step} outlive the latest "
                      f"stage-1 checkpoint ({latest}); keeping them (the producing "
                      "checkpoint was pruned; recover a consistent decoder with "
                      "cli/recon_refit)")
            return paths, False
    for stale in paths:
        print(f"[stage2] removing stale export {os.path.basename(stale)} "
              f"(stage-1 checkpoint is now {latest})")
        os.remove(stale)
    restored, step = ckpt.restore_state(os.path.join(args.out_dir, "train"))
    if restored is None:
        raise FileNotFoundError(f"no stage-1 campaign checkpoint under {args.out_dir}/train: "
                                "run cli/quality_eval (or cli/recon_refit) first")
    planes = restored["planes"].float().numpy()  # (N, L, 3, C3, D, D)
    print(f"[stage2] exporting {planes.shape[0]} campaign subjects (checkpoint step {step})")
    paths = []
    for i in range(planes.shape[0]):
        path = os.path.join(planes_dir, f"campaign{i:04d}_{step:06d}.npz")
        ckpt.save_subject_planes(path, planes[i], step)
        paths.append(path)
    return paths, True


def _loss_curve_section(diff_dir: str, max_rows: int = 12) -> list:
    """Training-loss curve from the diffusion leg's progress.csv, downsampled
    to ~max_rows rows (VERDICT r4 item 3: the report must show the curve, not
    just the final step)."""
    path = os.path.join(diff_dir, "progress.csv")
    if not os.path.exists(path):
        return []
    try:
        rows = np.genfromtxt(path, delimiter=",", names=True)
        steps = np.atleast_1d(rows["step"])
        loss = np.atleast_1d(rows["loss"])
    except Exception:
        return []
    if steps.size == 0:
        return []
    stride = max(1, steps.size // max_rows)
    picks = list(range(0, steps.size, stride))
    if picks[-1] != steps.size - 1:
        picks.append(steps.size - 1)
    out = ["## Training-loss curve (per-100-step means from progress.csv)",
           "", "| step | loss |", "|---|---|"]
    for i in picks:
        out.append(f"| {int(steps[i])} | {loss[i]:.4f} |")
    out.append("")
    return out


def _weights_fingerprint(state_dict) -> str:
    """Cheap identity of the weights that produced the samples: a hash of the
    four smallest tensors (every Adam step moves every trained tensor), so
    samples are tied to the weights scored and not only to a step number (a
    run with ``--final_save none`` retrains to the same step with other
    weights)."""
    tensors = sorted(state_dict.values(), key=lambda t: t.numel())[:4]
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _write_failure_report(work: str, stage: str, exc: BaseException) -> None:
    """Labelled STAGE2.md for any terminal path that is not a full success:
    whatever partial artifacts exist under ``work`` must never read as a
    completed run."""
    lines = [
        "# STAGE2 — generative-quality campaign (synthetic benchmark)",
        "",
        "## STATUS: FAILED / INCOMPLETE",
        "",
        f"The campaign terminated during the **{stage}** leg before scoring completed:",
        "",
        "```",
        f"{type(exc).__name__}: {exc}",
        "```",
        "",
        "Any samples/fidelity artifacts under this directory are PARTIAL output of "
        f"an incomplete run; do not read them as campaign results. Re-run `{CAMPAIGN_COMMAND}` "
        "(every leg resumes from its surviving artifacts); a successful run replaces "
        "this report.",
        "",
    ]
    try:
        os.makedirs(work, exist_ok=True)
        with open(os.path.join(work, "STAGE2.md"), "w") as f:
            f.write("\n".join(lines))
        print(f"[stage2] wrote FAILURE report {work}/STAGE2.md ({stage}: {exc})")
    except OSError as io_err:  # never mask the original failure
        print(f"[stage2] could not write failure report: {io_err}")


def main(argv=None):
    setup_runtime()
    args = build_parser().parse_args(argv)
    work = args.work_dir or os.path.join(args.out_dir, "stage2")
    if args.report_only:
        with open(os.path.join(work, "stage2_metrics.json")) as f:
            _write_success_report(work, json.load(f))
        return None
    status = {"stage": "setup"}
    mesh = None
    try:
        device, mesh = cli_mesh(args.device, args.dist_backend)
        return _run(args, work, status, device, mesh)
    except BaseException as exc:
        if is_root(mesh):
            _write_failure_report(work, status["stage"], exc)
        raise


def _run(args, work: str, status: dict, device, mesh) -> Optional[dict]:
    """The legs; under a mesh the training legs run on every rank and the
    rest on rank 0 (module docstring). Returns the metrics (None on the
    other ranks)."""
    root = is_root(mesh)
    dist_flags = ["--dist_backend", args.dist_backend] if args.dist_backend else []
    planes_dir = os.path.join(work, "planes")
    os.makedirs(planes_dir, exist_ok=True)

    # ---- 1. Export the campaign subjects --------------------------------
    status["stage"] = "stage-1 plane export"
    exports_changed = False
    if root:
        _, exports_changed = _export_campaign_planes(args, planes_dir)
    coll.barrier(mesh)
    campaign_paths = sorted(glob.glob(os.path.join(planes_dir, "campaign*.npz")))

    # ---- 2. Fine-tune extra subjects against the frozen decoder ---------
    status["stage"] = "frozen-decoder fine-tune"
    ft_paths = sorted(glob.glob(os.path.join(planes_dir, "subject*.npz")))
    if args.ft_subjects > 0 and len(ft_paths) < args.ft_subjects:
        from humanliff_tpu_torch.cli import recon_ft

        total = args.num_instance + args.ft_subjects
        recon_ft.main([
            "--data_set_type", "synthetic",
            "--basedir", args.out_dir,
            "--expname", "train",
            "--num_instance", str(total),
            "--start_idx", str(args.num_instance),
            "--end_idx", str(total),
            "--subjects_per_batch", str(args.ft_subjects),
            "--ft_steps", str(args.ft_steps),
            "--batch_size", str(args.ft_batch_size),
            "--n_rand", str(args.ft_n_rand),
            "--n_samples", str(args.n_samples),
            "--n_importance", str(args.n_importance),
            "--triplane_dim", str(args.triplane_dim),
            "--triplane_ch", str(args.triplane_ch),
            "--synthetic_image_size", str(args.image_size),
            "--synthetic_tight_bounds", "true",
            "--out_dir", planes_dir,
            "--seed", str(args.seed),
            "--device", args.device,
            *dist_flags,
        ])
        coll.barrier(mesh)
        ft_paths = sorted(glob.glob(os.path.join(planes_dir, "subject*.npz")))

    all_paths = campaign_paths + ft_paths
    if len(all_paths) < 2:
        raise RuntimeError("need >=2 subjects (1 train + 1 held out)")
    train_paths, heldout_path = all_paths[:-1], all_paths[-1]
    print(f"[stage2] {len(train_paths)} train subjects, "
          f"held out: {os.path.basename(heldout_path)}")

    # ---- 3. Pack + train the diffusion model ----------------------------
    status["stage"] = "diffusion training"
    from humanliff_tpu_torch.cli import diff_train
    from humanliff_tpu_torch.data.triplane_data import TriplaneDataset, pack_subject_planes
    from humanliff_tpu_torch.train import checkpoint as ckpt

    packed_train = os.path.join(work, "planes_train.npy")
    packed_held = os.path.join(work, "planes_heldout.npy")
    if exports_changed:
        # Fresh exports must flow into the training data: a stale pack would
        # silently train on the previous checkpoint's planes.
        for p in (packed_train, packed_held):
            if os.path.exists(p):
                print(f"[stage2] repacking {os.path.basename(p)} "
                      "(campaign exports were regenerated)")
                os.remove(p)
    if root and not os.path.exists(packed_train):
        pack_subject_planes(train_paths, packed_train)
    if root and not os.path.exists(packed_held):
        pack_subject_planes([heldout_path], packed_held)
    coll.barrier(mesh)

    diff_dir = os.path.join(work, "train")
    have_step = ckpt.latest_step(diff_dir) or 0
    if exports_changed and have_step > 0:
        print(f"[stage2] WARNING: the diffusion checkpoint (step {have_step}) was trained "
              f"on OLDER stage-1 exports; delete {diff_dir} to retrain against the "
              "regenerated planes")
    final_save = args.final_save or ("light" if args.light_final_save == "true" else "full")
    if mesh is not None and final_save == "none":
        raise ValueError("--final_save none under torchrun: rank 0 scores the final "
                         "checkpoint, since no rank holds the whole ZeRO-split EMA")
    state_mem = None
    if have_step < args.diff_steps:
        state_mem = diff_train.main([
            "--data_dir", packed_train,
            "--logdir", diff_dir,
            "--batch_size", str(args.diff_batch_size),
            "--lr", str(args.diff_lr),
            "--ema_rate", args.ema_rate,
            "--total_steps", str(args.diff_steps),
            "--save_interval", str(args.save_interval),
            "--log_interval", "100",
            "--image_size", str(args.triplane_dim),
            "--in_channels", str(args.triplane_ch),
            "--out_channels", str(args.triplane_ch),
            "--num_channels", str(args.num_channels),
            "--num_res_blocks", str(args.num_res_blocks),
            "--attention_resolutions", args.attention_resolutions,
            "--mid_save", args.mid_save,
            "--light_final_save", "true" if final_save == "light" else "false",
            "--skip_final_save", "true" if final_save == "none" else "false",
            "--seed", str(args.seed),
            "--device", args.device,
            *dist_flags,
        ])
    if not root:  # rank 0 samples, scores and reports
        return None
    if mesh is not None:  # this rank's ranges of the EMA: score the checkpoint
        state_mem = None

    # ---- 4. Resolve the scoring/sampling weights ------------------------
    # The in-memory final state when the training leg just ran (no save and
    # reload), the checkpoint otherwise (a resumed invocation).
    status["stage"] = "weight resolution"
    from humanliff_tpu_torch.eval.fidelity import (
        chain_fidelity_report,
        decoded_fidelity,
        heldout_denoise_loss,
    )
    from humanliff_tpu_torch.models.factory import (
        create_model_and_diffusion,
        model_and_diffusion_defaults,
    )
    from humanliff_tpu_torch.sampling.layered import generate_workload

    md = model_and_diffusion_defaults()
    md.update(image_size=args.triplane_dim, in_channels=args.triplane_ch,
              out_channels=args.triplane_ch, num_channels=args.num_channels,
              num_res_blocks=args.num_res_blocks,
              attention_resolutions=args.attention_resolutions)
    rate_str = args.ema_rate.split(",")[0]
    if state_mem is not None:
        dstep = int(state_mem.step)
        views = state_mem.layout.views
        raw_params = views(state_mem.params)
        ema, rate_str = ckpt.get_ema(
            {"ema_params": {r: views(e) for r, e in state_mem.ema_params.items()}}, rate_str)
        print(f"[stage2] scoring in-memory weights at step {dstep}")
    else:
        restored, dstep = ckpt.restore_state(diff_dir)
        if restored is None:
            raise FileNotFoundError(f"no diffusion checkpoint under {diff_dir} and the "
                                    "training leg did not run: delete stale samples or "
                                    "lower --diff_steps")
        raw_params = restored["params"]
        ema, rate_str = ckpt.get_ema(restored, rate_str)
        print(f"[stage2] scoring checkpoint weights at step {dstep}")
    # EMA burn-in guard: the EMA starts at the random init and after few steps
    # still carries rate^step of it; sampling such weights gives saturated noise.
    init_w = float(rate_str) ** max(int(dstep), 0)
    if init_w > 0.1:
        print(f"[stage2] WARNING: EMA({rate_str}) at step {dstep} still carries "
              f"{init_w:.1%} of the random init; sampling/scoring RAW params instead "
              "(use a faster --ema_rate for short runs)")
        score_params, weights_used = raw_params, "raw (EMA burn-in incomplete)"
    else:
        score_params, weights_used = ema, f"ema({rate_str})"
    weights_fp = _weights_fingerprint(score_params)
    with torch.device(device):
        model, diffusion = create_model_and_diffusion(**md)
    model.load_state_dict(score_params, strict=True)
    model.eval()
    if device.type == "cuda":  # bf16 weights, channels_last: the sampler's layout
        model.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    # Free the train state before sampling: at the flagship width it is about
    # 10 GB (params, gradients, Adam moments, EMA), headroom the B 8 chain
    # and the decode use.
    raw_params = ema = score_params = state_mem = restored = None
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- 4b. Sample the layered chain (mixed-batch plan) ----------------
    status["stage"] = "chain sampling"
    samples_dir = os.path.join(work, "samples")
    os.makedirs(samples_dir, exist_ok=True)
    sample_files = {name: os.path.join(samples_dir, f"samples_{name}.npz")
                    for name in LAYER_NAMES}
    # Samples are valid only if produced by the current weights: checked by
    # step and by the weights' fingerprint, both in a sidecar meta file.
    meta_path = os.path.join(samples_dir, "samples_meta.json")
    produced_by, produced_fp = -1, ""
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        produced_by = meta.get("diff_step", -1)
        produced_fp = meta.get("weights_fp", "")
    have_all = all(os.path.exists(p) for p in sample_files.values())
    if have_all and (produced_by != dstep or produced_fp != weights_fp):
        print(f"[stage2] resampling: existing samples from diff step {produced_by} "
              f"(fp {produced_fp or 'unknown'}), weights are now at {dstep} "
              f"(fp {weights_fp})")
        for p in list(sample_files.values()) + [os.path.join(samples_dir, "fidelity.json")]:
            if os.path.exists(p):
                os.remove(p)
        have_all = False
    if not have_all:
        md_s = dict(md, timestep_respacing=args.respacing)
        _, diffusion_s = create_model_and_diffusion(**md_s)
        out = generate_workload(
            model, diffusion_s, torch.Generator(device=device).manual_seed(args.seed + 3),
            args.num_samples, image_size=args.triplane_dim, channels=args.triplane_ch,
            device=device)
        samples = {n: a.float().cpu().numpy() for n, a in out.items()}
        del out
        for name, arr in samples.items():
            ckpt.save_samples_npz(sample_files[name], arr)
            print("[stage2] wrote", sample_files[name])
        with open(os.path.join(samples_dir, "fidelity.json"), "w") as f:
            json.dump(chain_fidelity_report(samples, args.fidelity_threshold), f, indent=2)
        with open(meta_path, "w") as f:
            json.dump({"diff_step": int(dstep), "weights_fp": weights_fp}, f)
    else:
        samples = {name: ckpt.load_samples_npz(path).astype(np.float32)
                   for name, path in sample_files.items()}

    # ---- 5. Score --------------------------------------------------------
    status["stage"] = "scoring"

    def plane_items(packed):
        ds = TriplaneDataset(packed)
        return [ds.item(i) for i in range(len(ds))]

    def score_generator():
        return torch.Generator(device=device).manual_seed(args.seed + 7)

    held_items = plane_items(packed_held)
    train_items = plane_items(packed_train)[:4]  # first train subject
    loss_held = heldout_denoise_loss(model, diffusion, held_items, score_generator(),
                                     args.n_eval_timesteps)
    loss_train = heldout_denoise_loss(model, diffusion, train_items, score_generator(),
                                      args.n_eval_timesteps)
    print(f"[stage2] denoise loss held-out {loss_held} / train {loss_train}")
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # Nearest-GT plane PSNR per layer (NHWC [-1, 1] space).
    gt = np.load(packed_train, mmap_mode="r")  # (N, L, C, D, D)
    nearest = {}
    for li, name in enumerate(LAYER_NAMES):
        arr = np.asarray(samples[name], np.float32)  # (B, D, D, C)
        best = []
        for b in range(arr.shape[0]):
            x = arr[b].transpose(2, 0, 1)  # (C, D, D)
            mses = [float(((x - np.asarray(gt[s, li], np.float32)) ** 2).mean())
                    for s in range(gt.shape[0])]
            best.append(-10.0 * np.log10(max(min(mses), 1e-12)))
        nearest[name] = float(np.mean(best))

    # Image-space chain consistency through the frozen Stage-1 decoder.
    from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
    from humanliff_tpu_torch.data.raygen import full_image_rays
    from humanliff_tpu_torch.data.synthetic import SyntheticLayeredDataset
    from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
    from humanliff_tpu_torch.nerf.decoder import FlatDecoder, NeRFDecoder
    from humanliff_tpu_torch.nerf.renderer import RenderConfig
    from humanliff_tpu_torch.sampling.layered import planes_image_to_triplane
    from humanliff_tpu_torch.utils.video import write_png

    # The decoder must match the checkpoint that produced the plane exports:
    # its decoder_{step}.npz sidecar when it survives (the producing
    # checkpoint may be pruned), else the latest Stage-1 checkpoint.
    m = re.search(r"_(\d{6})\.npz$", os.path.basename(campaign_paths[0]))
    decoder = NeRFDecoder(d_in=args.triplane_ch)
    side = (os.path.join(args.out_dir, "train", f"decoder_{int(m.group(1)):06d}.npz")
            if m else None)
    if side is not None and os.path.exists(side):
        decoder.load_state_dict(decoder_state_dict(ckpt.load_decoder_npz(side)))
        print(f"[stage2] decoder from sidecar {side}")
    else:
        s1, _ = ckpt.restore_state(os.path.join(args.out_dir, "train"))
        if s1 is None:
            raise FileNotFoundError(f"no decoder sidecar or stage-1 checkpoint under "
                                    f"{args.out_dir}/train")
        decoder.load_state_dict(FlatDecoder(s1["decoder"]).state_dict())
        del s1
    decoder = decoder.to(device).eval()

    # One shared box: the union of the campaign and fine-tuned subjects'
    # tight boxes (generated planes exist only in normalized plane space; any
    # common box gives a consistent scene for a layer-pair comparison).
    n_subjects = args.num_instance + args.ft_subjects
    dsu = SyntheticLayeredDataset(num_instances=n_subjects, image_size=args.decode_size,
                                  tight_bounds=True)
    boxes = np.stack([dsu.instance_bounds(i) for i in range(n_subjects)])
    box = np.stack([boxes[:, 0].min(0), boxes[:, 1].max(0)]).astype(np.float32)

    S = args.decode_size
    K, R, T = NovelViewCameras(image_size=S).camera(0)
    ro, rd, near, far, mask = full_image_rays(S, S, K, R, T, box)
    cfg = RenderConfig(n_samples=args.n_samples, n_importance=args.n_importance,
                       perturb=False, density_noise=False)

    def render_layer(x_img):
        planes = planes_image_to_triplane(
            torch.from_numpy(np.asarray(x_img, np.float32)).to(device)).contiguous()
        out = render_image_masked(decoder, planes, ro, rd, near, far, mask, box, cfg,
                                  outputs=("rgb", "acc"))
        return out["rgb"].float().cpu().numpy(), out["acc"].float().cpu().numpy()

    def to_u8(a):
        return (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)

    rend = {name: render_layer(samples[name][0]) for name in LAYER_NAMES}
    # Visual evidence: one decoded render per generated layer (the analog of
    # triplane_sample_layered.py:152-179's saved decode images).
    for li, name in enumerate(LAYER_NAMES):
        rgb, acc = rend[name]  # flat (S*S, 3) / (S*S,) maps
        write_png(os.path.join(samples_dir, f"decoded_l{li}_{name}.png"),
                  to_u8(rgb.reshape(S, S, 3)))
        write_png(os.path.join(samples_dir, f"decoded_l{li}_{name}_acc.png"),
                  to_u8(acc.reshape(S, S)))
    decoded = {}
    for prev, cur in zip(LAYER_NAMES[:-1], LAYER_NAMES[1:]):
        rgb0, acc0 = rend[prev]
        rgb1, acc1 = rend[cur]
        decoded[f"{prev}->{cur}"] = decoded_fidelity(rgb1, acc1, rgb0, acc0)
        print(f"[stage2] decoded {prev}->{cur}: {decoded[f'{prev}->{cur}']}")

    fid_path = os.path.join(samples_dir, "fidelity.json")
    if os.path.exists(fid_path):
        with open(fid_path) as f:
            plane_fid = json.load(f)
    else:  # samples of a partial earlier run without their fidelity.json
        plane_fid = chain_fidelity_report(samples, args.fidelity_threshold)

    # ---- 6. Report -------------------------------------------------------
    status["stage"] = "report"
    metrics = {
        "diff_step": int(dstep),
        "weights": weights_used,
        "weights_fp": weights_fp,
        "ema_rate": rate_str,
        "diff_steps": int(args.diff_steps),
        "num_samples": int(args.num_samples),
        "respacing": args.respacing,
        "n_eval_timesteps": int(args.n_eval_timesteps),
        "n_campaign_subjects": len(campaign_paths),
        "n_ft_subjects": len(ft_paths),
        "train_subjects": [os.path.basename(p) for p in train_paths],
        "heldout_subject": os.path.basename(heldout_path),
        "denoise_loss_heldout": loss_held,
        "denoise_loss_train": loss_train,
        "nearest_gt_psnr": nearest,
        "plane_fidelity": plane_fid,
        "decoded_fidelity": decoded,
        "decode_box": box.tolist(),
    }
    _write_success_report(work, metrics)
    # stage2_metrics.json is written last: the one artifact that exists only
    # after a fully successful run (STAGE2.md also exists on failure paths).
    with open(os.path.join(work, "stage2_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(f"[stage2] wrote {work}/stage2_metrics.json")
    return metrics


def _write_success_report(work: str, metrics: dict) -> None:
    """STAGE2.md from the metrics dict (regenerable offline: --report_only
    rebuilds the report from stage2_metrics.json + the samples/train dirs
    without touching weights or the device)."""
    dstep = metrics["diff_step"]
    weights_used = metrics["weights"]
    rate_str = metrics["ema_rate"]
    loss_held = metrics["denoise_loss_heldout"]
    loss_train = metrics["denoise_loss_train"]
    plane_fid = metrics["plane_fidelity"]
    decoded = metrics["decoded_fidelity"]
    nearest = metrics["nearest_gt_psnr"]
    n_train = len(metrics["train_subjects"])
    # Context keys absent from metrics.json files written before --report_only
    # existed get best-effort defaults (dstep IS the trained step count when
    # training ran to completion in one campaign).
    metrics = dict(metrics)
    metrics.setdefault("diff_steps", dstep)
    metrics.setdefault("num_samples", "n")
    metrics.setdefault("respacing", "250")
    metrics.setdefault("n_eval_timesteps", 16)
    metrics.setdefault("n_campaign_subjects", "?")
    metrics.setdefault("n_ft_subjects", "?")
    lines = [
        "# STAGE2 — generative-quality campaign (synthetic benchmark)",
        "",
        f"Diffusion weights: step {dstep}, {weights_used} (fingerprint "
        f"{metrics.get('weights_fp', 'n/a')}); campaign command: "
        f"`{CAMPAIGN_COMMAND}`",
        "",
        f"Training scale: {metrics['diff_steps']} diffusion steps on one "
        "device. The reference trains its SynBody model 200k-300k steps on 8 "
        "GPUs (README.md:149); this campaign demonstrates that the pipeline "
        "learns the layered distribution and the chain conditions — it is "
        "evidence of a working generative stack at campaign scale, not "
        "reference-matching sample quality.",
        "",
        f"Pipeline: stage-1 campaign planes "
        f"({metrics['n_campaign_subjects']} subjects) "
        f"+ {metrics['n_ft_subjects']} frozen-decoder fine-tuned subjects "
        f"(run_nerf_batch_ft.py flow) -> flagship ControlNet UNet trained "
        f"{metrics['diff_steps']} steps on {n_train} subjects x 4 layers "
        f"(subject `{metrics['heldout_subject']}` fully held out) -> "
        f"{metrics['num_samples']}-sample 4-layer chain (mixed-batch plan, "
        f"{weights_used} weights), {metrics['respacing']} respaced steps.",
        "",
        "## Held-out vs train denoise loss (stratified t-grid, "
        f"{metrics['n_eval_timesteps']} timesteps)",
        "",
        "| layer | held-out loss | train loss |",
        "|---|---|---|",
    ]
    for li in sorted(loss_held):
        lines.append(f"| {li} | {loss_held[li]:.5f} | "
                     f"{loss_train.get(li, float('nan')):.5f} |")
    lines += [
        "",
        "## Chain fidelity (generated layer k vs its x_cond layer k-1)",
        "",
        "| pair | change fraction | outside-change PSNR (planes) | "
        "changed px fraction | unchanged PSNR (decoded) | occupancy "
        "persistence |",
        "|---|---|---|---|---|---|",
    ]
    for pair in plane_fid:
        pf = plane_fid[pair]
        df = decoded.get(pair, {})
        lines.append(
            f"| {pair} | {pf['change_fraction']:.3f} | "
            f"{pf['outside_psnr']:.2f} | "
            f"{df.get('changed_pixel_fraction', float('nan')):.3f} | "
            f"{df.get('unchanged_psnr', float('nan')):.2f} | "
            f"{df.get('occupancy_persistence', float('nan')):.3f} |"
        )
    lines += [
        "",
        "## Nearest-GT plane PSNR (coverage / sample realism)",
        "",
        "| layer | PSNR vs nearest train subject (dB) |",
        "|---|---|",
    ]
    for name in LAYER_NAMES:
        lines.append(f"| {name} | {nearest[name]:.2f} |")
    lines.append("")
    # Visual evidence inline: the decoded render (+ opacity) of sample 0 of
    # each GENERATED layer, straight from the frozen stage-1 decoder — the
    # analog of the reference's saved decode images
    # (triplane_sample_layered.py:152-179).
    pngs = [
        (name, f"samples/decoded_l{li}_{name}.png")
        for li, name in enumerate(LAYER_NAMES)
        if os.path.exists(os.path.join(work, "samples",
                                       f"decoded_l{li}_{name}.png"))
    ]
    if pngs:
        lines += ["## Decoded renders (sample 0, frozen stage-1 decoder)", ""]
        lines.append("| " + " | ".join(n for n, _ in pngs) + " |")
        lines.append("|" + "---|" * len(pngs))
        lines.append(
            "| " + " | ".join(f"![{n}]({p})" for n, p in pngs) + " |")
        lines.append("")
    lines += _loss_curve_section(os.path.join(work, "train"))
    if weights_used.startswith("raw"):
        lines += [
            "## WARNING: scored RAW params (EMA burn-in incomplete)",
            "",
            f"EMA({rate_str}) at step {dstep} still carried >10% of the "
            "random init, so the campaign scored the raw training weights "
            "instead. Train longer (or use a faster --ema_rate) for "
            "EMA-weight results.",
            "",
        ]
    with open(os.path.join(work, "STAGE2.md"), "w") as f:
        f.write("\n".join(lines))
    print(f"[stage2] wrote {work}/STAGE2.md")


if __name__ == "__main__":
    main(sys.argv[1:])
