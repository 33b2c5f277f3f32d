#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``humanliff_tpu_torch``) once on one NVIDIA H100.

    python3 chip_smoke.py [--steps 250] [--cli_steps ddim50]

The main path is flagship inference, what ``bench.py`` times for the JAX
package: four chained layers of the ControlNet UNet at full width
(27 x 256 x 256, 192 channels, 3 res blocks, attention at 32/16/8, y = k,
``timestep_respacing="250"`` DDPM at B = 1, seeded random weights, bf16
autocast, channels_last), then the 512^2 decode of the last layer
(``planes_image_to_triplane``, 128 + 128 samples, orbit camera 0) with the
fitted Stage-1 decoder of ``runs/quality/train``: the exact tier
(``render_image_masked``) and the default fast tier (``build_density_grid`` +
``render_image_fast``), the marching-cubes mesh, and the sampling CLI
(``humanliff_tpu_torch.cli.diff_sample``) as a user calls it.

Phases, each printed with its seconds and failed past its budget:

    build     nvcc builds csrc/fused_decoder.cu into build/torch_kernels/;
              ptxas' registers and spills (none allowed) and the HMMA count
              of each kernel variant from cuobjdump -sass                  120 s
    kernel    fused decoder vs its plain version (fitted weights, features
              sampled from fitted planes), M = 2^20 and 1,000,003, fp32 and
              bf16 inputs, full and density-only, and every shape the main
              path launches (a render chunk's passes, the grid build, a mesh
              tile, a Stage-1 step's coarse and fine pass); CUDA-event times
              beside the bound (decoder_bound_ms), and the backward of a
              Stage-1 fine pass (the plain recompute)                      120 s
    generate  the 4-layer chain; one bf16 UNet forward is first held
              against the fp32 forward                                    420 s
    decode    view 0 of the last generated layer and of the fitted
              campaign planes, exact and fast tier: launch counts checked,
              a CPU re-render of a seeded random ray subset with the plain
              decoder for each tier on both planes (half the fast tier's
              subset from its kept rays), fast vs exact on the fitted
              planes                                                      180 s
    mesh      extract_mesh at 512^3 on the fitted planes                  120 s
    cli       the CLI's --sample_npz chain from generated layer 2 with
              DDIM, --decode (40 views, fast tier, 128^3 mesh) and
              --report_fidelity, from the seeded UNet saved as an npz; its
              launches against a count worked out from the saved sample    360 s
    train     Stage-2 training (humanliff_tpu_torch.cli.diff_train), five
              checks: one fp32 step at a small width on the card against
              the same step on the CPU; 20 steps of the CLI at the flagship
              width on the fitted campaign planes (B 8, microbatches of 2,
              bf16, data on the card) with s/step, device ms/step, busy
              share, peak memory and the full save; descent on a fixed
              batch; one step's loss and gradients in bf16 against fp32;
              the CLI resumed for a 21st step (the restore checked bit for
              bit), then diff_sample --model_dir on its checkpoint        300 s
    recon     Stage-1 reconstruction (humanliff_tpu_torch.cli.recon_train,
              recon_ft, recon_test), seven checks: one deterministic step
              at D 32 on the card against the CPU; 20 steps of recon_train
              --config configs/SynBody.txt on the synthetic bodies at image
              128 (100 instances, D 256, batch 2 x 2,048 rays, 128 + 128
              samples) with s/step, device ms/step, busy share, loader wait,
              peak memory and the save; descent on a fixed batch; after each
              of its steps the kernel against decoder_plain of the updated
              weights (the packed-weight cache); recon_ft of one subject from
              the saved state (the decoder bit for bit, the export packed
              for Stage 2); eval of the committed fitted pair against the
              JAX package's numbers (scripts/stage1_jax_reference.py), view
              by view, and the pair's loss; recon_test                    240 s
    canonical canonical space (TightCap) on the seeded SMPL-shaped synthetic
              body (J 24, V 6,890), six checks: the batched deform of 2 x
              2^20 points, card vs CPU (nearest-vertex ids and points), with
              the 1-NN and the whole deform timed and the deform's peak
              memory; one deterministic canonical step at D 32, card vs CPU;
              20 canonical steps at configs/TightCap.txt's width (107
              instances, D 256, 2 x 2,048 rays, 128 + 128 samples, fp32) on
              items of the TightCap loader's array half (data/tightcap.py::
              build_item, 512^2 images and garment masks from orbit cameras)
              with s/step, device ms/step, busy share, the deform's share of
              the kernel time and peak memory; descent on a fixed canonical
              batch; the kernel against decoder_plain on that batch's fine
              pass (deformed directions); the committed fitted planes
              through make_eval_deform_fn (scripts/canonical_jax_reference.py):
              the exact tier against JAX's, the fast tier against the exact
              one, the 128^3 mesh of the posed subject                   240 s
    quality   the quality campaigns (humanliff_tpu_torch.cli.recon_refit,
              quality_eval, quality_stage2, bench_decode) on the committed
              fitted pair copied into quality_stage2's layout, seven checks:
              recon_refit --refit_steps 0 (the planes and the decoder bit for
              bit the files, step 60000, the _REFIT.txt stamp); 20 refit steps
              at the campaign width (2 instances, D 256, 2 x 2,048 rays, 128 +
              128 samples, fp32) with s/step, the planes still bit for bit and
              the decoder moved; quality_eval --skip_train --fast_eval, each of
              the 16 exact views within QUALITY_EVAL_PSNR_DB of the JAX
              package's PSNR, QUALITY.md written, no LPIPS column; the full
              VGG16 LPIPS with seeded weights on two of its renders, card vs
              CPU; quality_stage2 at the flagship UNet width with STAGE2_FLAGS'
              cut depth (a success report with the JAX key set, finite losses
              and scores, a decode view against a CPU re-render, each leg's
              seconds and the peak memory); the seconds of a 4 x 250-step
              chain at B 1 and B 8 (sampling/layered.py::DEFAULT_CHAIN_COSTS)
              and the plan for 25 samples; bench_decode at 512^2, its fast
              tier at least FITTED_FAST_VS_EXACT_DB from its exact tier     300 s

Launch counts are set to 0 just before each path (the 4-layer generation and
exact decode, each grid build, each fast view, the fitted exact view, the
mesh, the CLI, Stage-2 training, recon_train, recon_ft, the Stage-1 eval,
recon_test, canonical training, and the canonical exact view, grid build,
fast view and mesh, and each quality CLI: recon_refit, quality_eval with
its exact and fast renders apart, quality_stage2 with its fine-tune and its
decode apart, bench_decode with its exact and fast renders apart) and read
just after it; Stage-2 training renders nothing
and must launch the decoder kernel 0 times, a Stage-1 step, world or
canonical, exactly twice (the coarse and the fine pass). The last three lines are a
``{"kernels": [...]}`` record, the card's name and power limit from
nvidia-smi, and ``{"ok": true, "device": {...}}``. Any failed check or blown
budget exits non-zero before the result. Without CUDA, or run outside a
checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DECODER_NPZ = os.path.join(REPO, "runs", "quality", "train", "decoder_060000.npz")
PLANES_NPZ = os.path.join(REPO, "runs", "quality", "stage2", "planes",
                          "campaign0000_060000.npz")
# The Stage-1 campaign's second subject, and the JAX package's numbers for the
# fitted pair (scripts/stage1_jax_reference.py, on the CPU).
PLANES_NPZ_1 = os.path.join(REPO, "runs", "quality", "stage2", "planes",
                            "campaign0001_060000.npz")
STAGE1_REFERENCE = os.path.join(REPO, "runs", "quality", "stage1_jax_reference.json")
SYNBODY_CONFIG = os.path.join(REPO, "configs", "SynBody.txt")
TIGHTCAP_CONFIG = os.path.join(REPO, "configs", "TightCap.txt")
# The JAX package's canonical-space render of the fitted planes and deform of
# a fixed query (scripts/canonical_jax_reference.py, on the CPU).
CANONICAL_REFERENCE = os.path.join(REPO, "runs", "quality", "canonical_jax_reference.npz")
BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)  # bench.py:200
BUDGET_S = {"build": 120, "kernel": 120, "generate": 420, "decode": 180, "mesh": 120,
            "cli": 360, "train": 300, "recon": 240, "canonical": 240, "quality": 300}
RENDER_CHUNK = 16384  # rays per render_rays call (render_image_masked's default)
GRID_RESOLUTION = 128  # the CLI's --grid_resolution default
GRID_CHUNK = 1 << 22  # lattice points per decoder call of build_density_grid
MESH_RESOLUTION = 512  # the CLI's --mesh_resolution default
MESH_CHUNK = 1 << 22  # points per decoder call of eval_density_grid
STAGE1_FINE_POINTS = 2 * 2048 * 256  # a Stage-1 step's fine pass: batch 2 x n_rand x 256
# The seeded random UNet's samples give a noisy density field: at 512^3 their
# mesh had 61.5 M triangles (a 1.2 GB PLY), so the CLI phase meshes at 128^3;
# the 512^3 mesh is the mesh phase's, of fitted planes.
CLI_MESH_RESOLUTION = 128
EARLY_TERM_EPS = 1e-2  # the CLI's --early_term_eps default
COARSE_CHUNK = 1 << 18  # rays per grid coarse phase call (render_image_fast's default)
FAST_GROUP = 1 << 21  # render_image_fast's max_rays_in_flight
# The CPU re-renders compare a ray subset; at least this share of it must be
# lit (acc > 0.01) on the card and on the CPU, so the subset meets the subject.
MIN_LIT_SHARE = 0.25
# The fast tier approximates the exact one. On the fitted campaign planes,
# view 0 at 512^2 in BOUNDS, the JAX package's own fast tier is 28.0526 dB
# (rgb PSNR over the in-box rays) from its exact tier
# (scripts/fast_tier_reference.py, on the CPU); the card's fast tier must come
# as close, less a margin. On an H100 (scripts/fast_tier_margin.py) the sound
# fast tier read 28.0525 dB on every run, and the nearest faulty variant below
# it (the grid's x and z axes swapped) 27.1589 dB: the margin is half of that
# 0.8936 dB gap.
FITTED_FAST_VS_EXACT_DB = 28.0526 - 0.447

# Training's descent check: after 10 steps on one fixed batch, t and noise
# (lr 5e-5, B 8 in microbatches of 2, bf16) the loss must have fallen by this
# share of its first value. The CPU rehearsal at image 16 and 32 channels, on
# the fitted planes resized, fell 0.76 % (1.0036 -> 0.9959; 1.42 % at image 32
# and 64 channels): the bar is half of the small width's drop.
DESCENT_MIN_DROP = 0.0038
# bf16 autocast against fp32 (TF32 off), one flagship step on that batch,
# seeded weights: bars on the loss's relative difference and the gradients'
# relative L2, about 10x and 6x what an H100 (700 W) measured: 5.36e-5 and
# 5.11e-3.
BF16_LOSS_REL, BF16_GRAD_REL = 5e-4, 3e-2

# Stage 1 (the recon phase). Check 1, one deterministic step at D 32 on the
# card (the kernel's forward, 3xTF32) and on the CPU (the plain decoder):
# metrics rtol RECON_SMALL_METRIC_REL, each group's first moment relative L2
# RECON_SMALL_MOMENT_REL; parameters within RECON_STEP_APART x lr where the
# gradient is at least RECON_NEAR_ZERO_GRAD (100 x Adam's eps; below it
# Adam's step reads the gradient's last bits, and both sides may step up to 2
# lr apart: tests/test_torch_stage1.py). The bars are about 10x what an H100
# (700 W) read: metrics 1.65e-7, moments 1.94e-5 (planes) and 9.5e-6
# (decoder), parameters 2.4e-5 lr (decoder; planes 3.9e-6 lr).
RECON_SMALL_METRIC_REL, RECON_SMALL_MOMENT_REL = 2e-6, 2e-4
RECON_NEAR_ZERO_GRAD, RECON_STEP_APART = 1e-6, 3e-4
# Check 3: 10 deterministic steps on one fixed batch at the full width must
# lower the loss by this share of its first value: half of the 16.00 % an
# H100 read (the CPU rehearsal at D 32: 57.9 %).
RECON_DESCENT_MIN_DROP = 0.08
# Check 6, against the JAX package on the CPU (STAGE1_REFERENCE): each
# held-out view's PSNR within RECON_EVAL_PSNR_DB (an H100 read at most
# 0.00595 dB), the pair's loss on the reference batch within RECON_LOSS_REL
# (read 4.7e-5).
RECON_EVAL_PSNR_DB, RECON_LOSS_REL = 0.1, 5e-4

# Canonical space (the canonical phase). Check 1, the batched deform on the
# card against the CPU: nearest-vertex ids agree on at least this share of
# the points, and where they agree points and directions within
# CANON_DEFORM_ATOL. Check 4: 10 deterministic canonical steps on one fixed
# batch lower the loss by this share. Check 6: the card's exact tier within
# CANON_EXACT_DB of the JAX package's (PSNR over the in-box rays); its fast
# tier at least as close to its exact tier as the JAX package's own, less
# CANON_FAST_MARGIN_DB.
CANON_ID_AGREE, CANON_DEFORM_ATOL = 0.9999, 1e-4
CANON_DESCENT_MIN_DROP = 0.05
CANON_EXACT_DB, CANON_FAST_MARGIN_DB = 40.0, 0.5
# The deform's 1-NN: 2 x 2^20 query points.
CANON_DEFORM_POINTS = 1 << 20

# The quality campaigns (the quality phase). Check 3: each exact held-out view
# of quality_eval on the reassembled committed pair within QUALITY_EVAL_PSNR_DB
# of the JAX package's PSNR (STAGE1_REFERENCE; the recon phase's check 6 read at
# most 0.00595 dB on an H100). Check 4: LPIPS of the full VGG16 tower, card
# against CPU, relative. Check 5 runs quality_stage2 with STAGE2_FLAGS: the
# flagship UNet width, the depth cut (20 fine-tune steps, 10 diffusion steps,
# 8 samples of 10 respaced steps, 128^2 decode, 4 eval timesteps); its metrics
# must carry STAGE2_JAX_KEYS, the keys of the JAX CLI's stage2_metrics.json,
# and bench_decode's JSON BENCH_DECODE_JAX_KEYS, the JAX CLI's.
QUALITY_EVAL_PSNR_DB, LPIPS_RTOL = 0.05, 1e-4
STAGE2_FLAGS = ("--ft_subjects", "1", "--ft_steps", "20", "--diff_steps", "10",
                "--save_interval", "10", "--num_samples", "8", "--respacing", "10",
                "--decode_size", "128", "--n_eval_timesteps", "4")
STAGE2_JAX_KEYS = ("diff_step", "weights", "weights_fp", "ema_rate", "diff_steps",
                   "num_samples", "respacing", "n_eval_timesteps", "n_campaign_subjects",
                   "n_ft_subjects", "train_subjects", "heldout_subject",
                   "denoise_loss_heldout", "denoise_loss_train", "nearest_gt_psnr",
                   "plane_fidelity", "decoded_fidelity", "decode_box")
BENCH_DECODE_JAX_KEYS = ("checkpoint_step", "render_size", "num_views", "exact_s_per_view",
                         "fast_s_per_view", "speedup", "exact_s_per_view_median",
                         "fast_s_per_view_median", "speedup_median", "fast_vs_exact_psnr_db",
                         "grid_build_s", "fast_first_view_incl_grid_s", "early_term_eps",
                         "dtype")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, flop/s of the
# tensor cores in TF32 and bf16. The data sheet's tensor-core peaks hold at the
# SM clock they imply, 495 TFLOP/s / (132 SMs x 2,048 TF32 flop per clock) =
# 1.83 GHz; the special-function units, 16 results per SM and clock, are
# counted at that clock too.
PEAK_BYTES_S = 3.35e12
PEAK_TF32_S = 495e12
PEAK_FLOPS_S = {"bfloat16": 989e12, "float32": PEAK_TF32_S}  # one pass at the input type
PEAK_SFU_S = 132 * 16 * PEAK_TF32_S / (132 * 2048)
# Multiply-adds per point of the decoder (weights 66,884 = these + biases).
MACS_DENSITY = 27 * 128 + 128 * 128 + 155 * 128 + 128
MACS_FULL = MACS_DENSITY + 128 * 128 + 155 * 64 + 64 * 3
# Of those, the ones whose activation is exact in TF32 for bf16 inputs (the
# x rows of W0 and W2, the PE4 rows of Wv): the kernel skips their lo.hi.
MACS_EXACT_DENSITY = 2 * 27 * 128
MACS_EXACT_FULL = MACS_EXACT_DENSITY + 27 * 64
# Special-function results per point: an ex2 and a lg2 per softplus (3 x 128
# trunk, 64 view), and the 24 sin/cos of PE4.
SFU_DENSITY = 2 * 3 * 128
SFU_FULL = 2 * (3 * 128 + 64) + 24


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


class Phase:
    """Prints a phase's seconds and fails it past its budget."""

    def __init__(self, name: str, sync):
        self.name, self.sync = name, sync

    def __enter__(self):
        say(f"[{self.name}] start")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.sync()
        seconds = time.perf_counter() - self.t0
        budget = BUDGET_S[self.name]
        status = "failed" if exc_type else ("over budget" if seconds > budget else "ok")
        say(f"[{self.name}] {status}: {seconds:.3f} s (budget {budget} s)")
        if exc_type is None and seconds > budget:
            raise CheckFailed(f"phase {self.name} took {seconds:.1f} s > {budget} s")
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events around ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def decoder_bound_ms(M: int, dtype: str, full: bool) -> dict:
    """Least time for the decoder on M points, the largest of three terms:

    - bytes: inputs read once, fp32 outputs written once, weights once, over
      HBM bandwidth;
    - tensor: three TF32 products per multiply-add (two where the activation
      is exact in TF32: bf16 inputs' x and PE4 rows) over the dense TF32
      peak. The kernel's tolerance needs them for both input types: in one
      TF32 pass the fitted decoder misses it more than tenfold, in split TF32
      (hi.hi + hi.lo + lo.hi) it meets it (tests/test_torch_decoder_precision.py
      emulates both on points sampled from fitted planes);
    - special-function: an ex2 and a lg2 per softplus and 24 sin/cos per
      point over the SMs' 16 results per clock.

    Returns ``ms``, ``term`` (the binding one), ``by`` ("bytes" or
    "operations") and ``ms_one_pass``, the earlier basis (one tensor-core
    pass at the bf16 or TF32 peak, no special-function term), so ratios
    taken on it still compare.
    """
    in_bytes = 2 if dtype == "bfloat16" else 4
    n_in = 30 if full else 27
    n_out = 4 if full else 1
    bytes_ = M * (n_in * in_bytes + n_out * 4) + 66884 * 4
    macs = M * (MACS_FULL if full else MACS_DENSITY)
    exact = M * (MACS_EXACT_FULL if full else MACS_EXACT_DENSITY) if in_bytes == 2 else 0
    terms = {
        "bytes": 1e3 * bytes_ / PEAK_BYTES_S,
        "tf32 tensor": 1e3 * 2 * (3 * macs - exact) / PEAK_TF32_S,
        "special-function": 1e3 * M * (SFU_FULL if full else SFU_DENSITY) / PEAK_SFU_S,
    }
    term = max(terms, key=terms.get)
    return {"ms": terms[term], "term": term,
            "by": "bytes" if term == "bytes" else "operations",
            "ms_one_pass": max(terms["bytes"], 1e3 * 2 * macs / PEAK_FLOPS_S[dtype])}


def load_fitted_decoder(device):
    from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
    from humanliff_tpu_torch.nerf.decoder import NeRFDecoder

    dec = NeRFDecoder()
    with np.load(DECODER_NPZ) as f:
        dec.load_state_dict(decoder_state_dict(dict(f)), strict=True)
    return dec.to(device).eval()


def load_fitted_planes(layer: int):
    import torch

    with np.load(PLANES_NPZ) as f:
        return torch.from_numpy(np.ascontiguousarray(f["tri_planes"][layer]))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_build() -> dict:
    """Build the kernel, print ptxas' registers, spills and shared memory, and
    hold the machine code to the design: tensor-core mma (HMMA) in every
    kernel variant, no spills and no local-memory loads or stores."""
    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.ops import fused_decoder as fd

    fd._library()
    rec = kernels.BUILD_LOG[fd.NAME]
    say(f"[build] {os.path.relpath(rec['path'], REPO)} built in {rec['seconds']:.3f} s"
        f" (cached: {rec['cached']})")
    for line in rec["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            say(f"[build] ptxas: {line.strip()}")
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", rec["ptxas"])
    check(not rec["ptxas"] or (spills and all(a == b == "0" for a, b in spills)),
          f"ptxas reports spills: {spills}")
    counts, fn = {}, None
    for line in kernels.sass(rec["path"]).splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HMMA": 0, "local": 0}
        elif fn is not None and "*/" in line:
            tokens = line.split("*/", 1)[1].split()
            if tokens and tokens[0].startswith("@"):  # a predicate guard
                tokens = tokens[1:]
            op = tokens[0] if tokens else ""
            counts[fn]["HMMA"] += op.startswith("HMMA")
            counts[fn]["local"] += op.startswith(("LDL", "STL"))
    for fn, c in counts.items():
        say(f"[build] sass {fn}: {c['HMMA']} HMMA, {c['local']} local loads/stores")
    check(len(counts) == 4, f"expected 4 kernel variants in the SASS, found {list(counts)}")
    check(all(c["HMMA"] > 0 and c["local"] == 0 for c in counts.values()),
          f"a variant lacks HMMA or touches local memory: {counts}")
    rec["sass"] = counts
    return rec


def phase_kernel(device, sizes=(1 << 20, 1_000_003), time_sizes=(1 << 20,),
                 main_fine_points=RENDER_CHUNK * 256,
                 grid_points=(GRID_RESOLUTION + 1) ** 3, mesh_points=MESH_CHUNK,
                 stage1_fine_points=STAGE1_FINE_POINTS, reps=10) -> dict:
    """Hold the kernel against decoder_plain and time both, at the sizes given
    and at every shape the main path launches; and time the backward of a
    Stage-1 fine pass (the plain recompute and its gradients)."""
    import torch
    import torch.nn.functional as F

    from humanliff_tpu_torch.ops.fused_decoder import decoder_plain, fused_decoder
    from humanliff_tpu_torch.ops.triplane import sample_triplane_features

    dec = load_fitted_decoder(device)
    w = tuple(t.detach() for t in dec.weights())
    planes = load_fitted_planes(3).to(device)
    box = torch.from_numpy(BOUNDS).to(device)
    gen = torch.Generator(device=device).manual_seed(1)

    def inputs(M, dtype):
        lo, hi = box[0], box[1]
        coords = torch.rand(M, 3, generator=gen, device=device) * (hi - lo) + lo
        feats = sample_triplane_features(planes, coords, box).to(dtype).contiguous()
        dirs = F.normalize(torch.randn(M, 3, generator=gen, device=device), dim=-1)
        return feats, dirs.to(dtype).contiguous()

    # The main path's shapes: a render chunk's fine pass (bf16, full; the fast
    # tier's fine tiles too) and the exact tier's coarse pass (bf16,
    # density-only); the density grid's build (bf16, density-only) and a mesh
    # tile (fp32 features, density-only).
    main_shapes = [(main_fine_points, "bfloat16", True),
                   (main_fine_points // 2, "bfloat16", False),
                   (grid_points, "bfloat16", False),
                   (mesh_points, "float32", False)]
    # A Stage-1 training step (batch 2 x 2,048 rays): the coarse pass, density
    # only, and the fine pass, full, both fp32.
    stage1_shapes = [(stage1_fine_points // 2, "float32", False),
                     (stage1_fine_points, "float32", True)]
    main_shapes += [shape for shape in stage1_shapes if shape not in main_shapes]
    checks = list(dict.fromkeys([(M, dt, full) for M in sizes for dt in ("float32", "bfloat16")
                                 for full in (True, False)] + main_shapes))
    max_err = 0.0
    with torch.no_grad():
        for M, dtype, full in checks:
            feats, dirs = inputs(M, getattr(torch, dtype))
            d = dirs if full else None
            ref_rgb, ref_alpha = decoder_plain(w, feats, d)
            rgb, alpha = fused_decoder(w, feats, d)
            if device.type == "cuda":
                torch.cuda.synchronize()
            pairs = [(alpha, ref_alpha)] + ([(rgb, ref_rgb)] if full else [])
            scale = max(float(r.abs().max()) for _, r in pairs)
            err = max(float((o - r).abs().max()) for o, r in pairs)
            # fp32: 155-term fp32 sums in another order. bf16: the same bf16
            # inputs; PE4 values rounded to bf16 may land one bf16 ulp apart
            # where libm's sin/cos differ in the last bit.
            tol = (1e-4 if dtype == "float32" else 1e-2) + 1e-5 * scale
            finite = all(bool(torch.isfinite(o).all()) for o, _ in pairs)
            ok = finite and err <= tol
            say(f"[kernel] M={M} {dtype} {'full' if full else 'density'}: "
                f"max_abs_err={err:.3e} tol={tol:.3e} max|ref|={scale:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"fused_decoder disagrees with its plain version at "
                      f"M={M} {dtype} full={full}: {err} > {tol}")
            max_err = max(max_err, err)
            del feats, dirs, ref_rgb, ref_alpha, rgb, alpha

        timings = {}
        shapes = list(dict.fromkeys([(M, dt, full) for M in time_sizes
                                     for dt in ("float32", "bfloat16")
                                     for full in (True, False)] + main_shapes))
        for M, dtype, full in shapes:
            feats, dirs = inputs(M, getattr(torch, dtype))
            d = dirs if full else None
            k_ms = cuda_ms(lambda: fused_decoder(w, feats, d), reps)
            p_ms = cuda_ms(lambda: decoder_plain(w, feats, d), reps)
            b = decoder_bound_ms(M, dtype, full)
            timings[(M, dtype, full)] = (k_ms, p_ms, b)
            say(f"[kernel] time M={M} {dtype} {'full' if full else 'density'}: "
                f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, plain/kernel "
                f"{p_ms / k_ms:.2f}x; bound {b['ms']:.4f} ms ({b['term']}), "
                f"kernel/bound {k_ms / b['ms']:.2f}x; one-pass basis {b['ms_one_pass']:.4f} ms, "
                f"kernel/bound {k_ms / b['ms_one_pass']:.1f}x")
            del feats, dirs
        # The fine pass's backward in training: _FusedDecoderFn.backward's
        # work, the plain decoder again and the gradients of its inputs and
        # weights.
        feats, dirs = inputs(stage1_fine_points, torch.float32)
        grads = (torch.randn(stage1_fine_points, 3, generator=gen, device=device),
                 torch.randn(stage1_fine_points, 1, generator=gen, device=device))

        def backward():
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True) for t in (feats, *w)]
                outs = decoder_plain(leaves[1:], leaves[0], dirs)
                torch.autograd.grad(outs, leaves, grads)

        bwd_ms = cuda_ms(backward, reps)
        say(f"[kernel] time the backward of a Stage-1 fine pass (M={stage1_fine_points} fp32, "
            f"the plain recompute and its gradients): {bwd_ms:.4f} ms")
        del feats, dirs, grads
    k_ms, p_ms, b = timings[(main_fine_points, "bfloat16", True)]
    shapes = [{"M": M, "dtype": dt, "variant": "full" if full else "density",
               "ms": timings[(M, dt, full)][0], "plain_ms": timings[(M, dt, full)][1],
               "bound_ms": timings[(M, dt, full)][2]["ms"]} for M, dt, full in main_shapes]
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound": b,
            "main_shapes": shapes, "stage1_backward_ms": bwd_ms}


def seed_weights(model, seed: int) -> None:
    """Seeded random weights for every layer, zero-init ones included, so each
    path carries signal: N(0, 1/fan_in) matrices and kernels, N(0, 0.02) biases,
    GroupNorm scales 1 + N(0, 0.02)."""
    import torch

    p0 = next(model.parameters())
    gen = torch.Generator(device=p0.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen, device=p.device)
            if p.dim() >= 2:
                p.copy_(noise / math.sqrt(p[0].numel()))
            elif name.endswith("weight"):  # GroupNorm scale
                p.copy_(1.0 + 0.02 * noise)
            else:
                p.copy_(0.02 * noise)


def phase_generate(device, steps: int, model_kwargs=None, image_size=256) -> dict:
    import torch

    from humanliff_tpu_torch.models.factory import create_model_and_diffusion
    from humanliff_tpu_torch.sampling.layered import LAYER_NAMES, generate_all_layers

    kw = dict(timestep_respacing=str(steps))
    kw.update(model_kwargs or {})
    with torch.device(device):
        model, diffusion = create_model_and_diffusion(**kw)
    model.eval()
    seed_weights(model, 0)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[generate] UNet {n_params:,} parameters, {diffusion.num_timesteps} DDPM steps "
        f"per layer")

    # One forward in bf16 autocast (channels_last) against the fp32 forward.
    gen = torch.Generator(device=device).manual_seed(2)
    C = kw.get("in_channels", 27)
    x = torch.randn(1, C, image_size, image_size, generator=gen, device=device)
    xc = torch.randn(1, C, image_size, image_size, generator=gen, device=device)
    t = torch.tensor([500.0], device=device)
    y = torch.tensor([1], device=device)
    cl = torch.channels_last
    with torch.no_grad():
        ref = model(x, t, xc, y).float()
        if device.type == "cuda":
            model.to(dtype=torch.bfloat16, memory_format=cl)
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=device.type == "cuda"):
            out = model(x.to(memory_format=cl), t, xc.to(memory_format=cl), y).float()
    rel = float((out - ref).norm() / ref.norm())
    say(f"[generate] bf16 vs fp32 UNet forward: relative L2 error {rel:.4e} (tol 5e-2), "
        f"|out| rms {float(ref.pow(2).mean().sqrt()):.3e}")
    check(bool(torch.isfinite(out).all()) and rel <= 5e-2,
          f"bf16 UNet forward disagrees with fp32: {rel}")

    stamps = [time.perf_counter()]

    def on_layer(name, samples):
        if device.type == "cuda":
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        say(f"[generate] layer {name}: {stamps[-1] - stamps[-2]:.3f} s")

    g = torch.Generator(device=device).manual_seed(3)
    layers = generate_all_layers(model, diffusion, generator=g, batch_size=1,
                                 image_size=image_size, channels=C, device=device,
                                 callback=on_layer)
    check(list(layers) == LAYER_NAMES, f"layers {list(layers)}")
    prev = None
    for name, s in layers.items():
        check(tuple(s.shape) == (1, image_size, image_size, C), f"{name} shape {s.shape}")
        check(bool(torch.isfinite(s).all()), f"{name} has non-finite values")
        check(float(s.abs().max()) <= 1.0 + 1e-5, f"{name} leaves [-1, 1]")
        if prev is not None:
            check(float((s - prev).abs().max()) > 1e-3, f"{name} equals the previous layer")
        prev = s
        say(f"[generate] {name}: mean {float(s.mean()):+.4f} std {float(s.std()):.4f}")
    per_layer = [b - a for a, b in zip(stamps, stamps[1:])]
    del model
    return {"layers": layers, "per_layer_s": per_layer, "steps": diffusion.num_timesteps}


def acc_stats(acc, mask) -> dict:
    a = acc[mask]
    return {"mean": float(a.mean()), "frac_gt_0.5": float((a > 0.5).mean()),
            "frac_saturated": float(((a < 0.1) | (a > 0.9)).mean())}


def psnr_db(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def expect_launches(device, got: int, expected: int, what: str) -> None:
    """Print a path's fused_decoder launches; on the card they must be the
    expected count (CPU tensors take the plain version and launch nothing)."""
    say(f"[launches] {what}: {got} (expected {expected})")
    if device.type == "cuda":
        check(got == expected and got > 0,
              f"{what} launched fused_decoder {got} times, expected {expected}")


def cpu_decoder(dec):
    from humanliff_tpu_torch.nerf.decoder import NeRFDecoder

    dec_cpu = NeRFDecoder()
    dec_cpu.load_state_dict({k: v.cpu() for k, v in dec.state_dict().items()})
    return dec_cpu


def check_rays(mask, n_check_rays: int, kept=None) -> np.ndarray:
    """A seeded random subset of the in-box rays for the CPU re-renders (a
    stride over the row-major pixels lands on the image's empty left edge).
    Where ``kept`` (a flag per pixel) is given, half of the subset is drawn
    from the rays the fast tier keeps."""
    rng = np.random.default_rng(0)
    pool = np.flatnonzero(mask)
    first = np.empty(0, np.int64)
    if kept is not None:
        kept_idx = np.flatnonzero(kept & mask)
        first = rng.choice(kept_idx, min(len(kept_idx), n_check_rays // 2), replace=False)
        pool = np.setdiff1d(pool, first)
    rest = rng.choice(pool, min(len(pool), n_check_rays - len(first)), replace=False)
    return np.sort(np.concatenate([first, rest]))


def compare_subset(out, ref, idx, label: str) -> dict:
    """The card's render at the rays ``idx`` against the CPU's: PSNR of rgb
    and acc (bar 45 dB), and the share of the subset lit on both sides (bar
    MIN_LIT_SHARE)."""
    card = {k: out[k].float().cpu().numpy()[idx] for k in ("rgb", "acc")}
    cpu = {k: ref[k].float().numpy() for k in ("rgb", "acc")}
    psnrs = {k: psnr_db(card[k], cpu[k]) for k in ("rgb", "acc")}
    lit = float(np.mean((card["acc"] > 0.01) & (cpu["acc"] > 0.01)))
    say(f"[decode] {label}: {len(idx)} rays vs CPU plain render: PSNR rgb "
        f"{psnrs['rgb']:.2f} dB, acc {psnrs['acc']:.2f} dB (bar 45 dB); lit on both "
        f"sides {lit:.4f} (bar {MIN_LIT_SHARE})")
    check(min(psnrs.values()) >= 45.0, f"{label} disagrees with the CPU plain path: {psnrs}")
    check(lit >= MIN_LIT_SHARE, f"{label}: the check rays miss the subject ({lit:.4f} lit)")
    return {**psnrs, "lit": lit}


def rerender_exact(dec, planes, ray_args, out, label: str, n_check_rays=256) -> dict:
    """The exact tier's card render of a ray subset against the same rays
    through ``render_rays`` on the CPU with the plain decoder."""
    import torch

    from humanliff_tpu_torch.nerf.renderer import render_rays

    ro, rd, near, far, mask, cfg = ray_args
    idx = check_rays(mask, n_check_rays)
    with torch.no_grad():
        ref = render_rays(cpu_decoder(dec), planes.cpu(),
                          *(torch.from_numpy(a[idx]) for a in (ro, rd, near, far)),
                          torch.from_numpy(BOUNDS), cfg)
    return compare_subset(out, ref, idx, f"exact tier, {label}")


def kept_rays(grid, rays, box, cfg, eps: float, deform=None):
    """The fast tier's keep flag (R,) of in-box rays (rays_o, rays_d, near,
    far on the device) at ``early_term_eps`` ``eps``, from the grid's coarse
    phase in render_image_fast's chunks (through ``deform`` where given); no
    decoder call."""
    import torch

    from humanliff_tpu_torch.nerf.fastpath import coarse_from_grid

    n = rays[0].shape[0]
    keep = []
    for s in range(0, n, COARSE_CHUNK):  # FAST_GROUP is a multiple of COARSE_CHUNK
        _, acc_est = coarse_from_grid(grid, *(r[s:s + COARSE_CHUNK] for r in rays), box, cfg,
                                      deform)
        keep.append(acc_est > eps)
    return torch.cat(keep)


def phase_decode(device, last_layer, image_size=512, n_samples=128) -> dict:
    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.data.raygen import full_image_rays
    from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
    from humanliff_tpu_torch.nerf.renderer import RenderConfig, render_image_masked
    from humanliff_tpu_torch.sampling.layered import planes_image_to_triplane

    dec = load_fitted_decoder(device)
    planes = planes_image_to_triplane(last_layer[0]).to(torch.bfloat16).contiguous()
    S = image_size
    K, R, T = NovelViewCameras(S).camera(0)
    ro, rd, near, far, mask = full_image_rays(S, S, K, R, T, BOUNDS)
    cfg = RenderConfig(n_samples=n_samples, n_importance=n_samples, perturb=False,
                       density_noise=False)

    t0 = time.perf_counter()
    out = render_image_masked(dec, planes, ro, rd, near, far, mask, BOUNDS, cfg)
    sync(device)
    render_s = time.perf_counter() - t0
    launches = kernels.LAUNCHES["fused_decoder"]
    n_rays = int(mask.sum())
    acc = out["acc"].float().cpu().numpy()
    rgb = out["rgb"].float().cpu().numpy()
    stats = acc_stats(acc, mask)
    say(f"[decode] exact tier, generated layer: {S}^2 view, {n_rays} rays in the box, "
        f"{2 * n_samples} samples/ray: {render_s:.3f} s; acc {json.dumps(stats)}")
    check(np.isfinite(rgb).all() and np.isfinite(acc).all(), "non-finite render")
    check(acc.min() >= 0.0 and acc.max() <= 1.0 + 1e-4, "acc leaves [0, 1]")

    psnrs = rerender_exact(dec, planes, (ro, rd, near, far, mask, cfg), out, "generated")
    return {"render_s": render_s, "launches": launches, "n_rays": n_rays, "rgb": rgb,
            "stats": stats, "psnr": psnrs, "planes": planes,
            "ray_args": (ro, rd, near, far, mask, cfg)}


def phase_fast(device, planes, ray_args, label: str, exact_rgb=None, exact_bar=None,
               grid_resolution=GRID_RESOLUTION, n_check_rays=256) -> dict:
    """The fast tier on one view: the grid build and ``render_image_fast``
    timed as bench.py times ``render_s`` (a warm-up call, then the grid build
    and the render, host clock after a synchronize), each path's launches
    checked (the grid's chunks, then one per 16,384 kept rays), the share of
    terminated rays, a CPU re-render of a ray subset (half of it kept rays)
    from the card's grid with the plain decoder (compare_subset), and the
    agreement with the exact tier over the in-box rays (bar ``exact_bar``
    where given)."""
    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.nerf.fastpath import (
        DensityGrid,
        build_density_grid,
        render_image_fast,
    )

    ro, rd, near, far, mask, cfg = ray_args
    dec = load_fitted_decoder(device)

    def grid_build():
        return build_density_grid(dec, planes, BOUNDS, resolution=grid_resolution,
                                  build_chunk=GRID_CHUNK)

    def render(grid):
        return render_image_fast(dec, planes, grid, ro, rd, near, far, mask, BOUNDS, cfg,
                                 chunk=RENDER_CHUNK, early_term_eps=EARLY_TERM_EPS)

    render(grid_build())  # warm-up, as bench.py
    sync(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    grid = grid_build()
    sync(device)
    grid_s = time.perf_counter() - t0
    grid_launches = kernels.LAUNCHES["fused_decoder"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = render(grid)
    sync(device)
    fast_s = time.perf_counter() - t0
    fast_launches = kernels.LAUNCHES["fused_decoder"]

    # The kept rays, from the same grid and chunks as the render.
    n_rays = int(mask.sum())
    rays = [torch.from_numpy(a[mask]).to(device) for a in (ro, rd, near, far)]
    keep = kept_rays(grid, rays, torch.from_numpy(BOUNDS).to(device), cfg,
                     EARLY_TERM_EPS).cpu().numpy()
    kept = int(keep.sum())
    kept_px = np.zeros(mask.shape, bool)
    kept_px[np.flatnonzero(mask)] = keep
    terminated = 1.0 - kept / n_rays
    R = grid_resolution
    expect_launches(device, grid_launches, math.ceil((R + 1) ** 3 / GRID_CHUNK),
                    f"grid build ({label}, {(R + 1) ** 3} points)")
    expect_launches(device, fast_launches, math.ceil(kept / RENDER_CHUNK),
                    f"fast view ({label}, {kept} of {n_rays} rays kept)")
    rgb = out["rgb"].cpu().numpy()
    acc = out["acc"].cpu().numpy()
    check(np.isfinite(rgb).all() and np.isfinite(acc).all(), f"non-finite fast render ({label})")
    check(acc.min() >= 0.0 and acc.max() <= 1.0 + 1e-4, f"fast acc leaves [0, 1] ({label})")
    say(f"[decode] fast tier, {label}: grid build {grid_s:.3f} s + render {fast_s:.3f} s = "
        f"{grid_s + fast_s:.3f} s (render_s as bench.py); terminated rays "
        f"{n_rays - kept} of {n_rays} ({terminated:.4f}); acc {json.dumps(acc_stats(acc, mask))}")

    # A ray subset, half of it kept rays, on the CPU: the card's grid, the
    # plain decoder.
    idx = check_rays(mask, n_check_rays, kept=kept_px)
    cpu_grid = DensityGrid(table=grid.table.cpu(), resolution=R)
    ref = render_image_fast(cpu_decoder(dec), planes.cpu(), cpu_grid, ro[idx], rd[idx],
                            near[idx], far[idx], np.ones(len(idx), bool), BOUNDS, cfg,
                            early_term_eps=EARLY_TERM_EPS)
    psnrs = compare_subset(out, ref, idx, f"fast tier, {label}")
    vs_exact = None
    if exact_rgb is not None:
        vs_exact = psnr_db(rgb[mask], exact_rgb[mask])
        bar = f"bar {exact_bar} dB" if exact_bar is not None else "no bar"
        say(f"[decode] fast vs exact tier, {label}: rgb PSNR {vs_exact:.4f} dB over "
            f"{n_rays} in-box rays ({bar})")
        check(exact_bar is None or vs_exact >= exact_bar,
              f"fast tier ({label}) is {vs_exact:.2f} dB from the exact tier")
    return {"grid_s": grid_s, "fast_s": fast_s, "render_s": grid_s + fast_s,
            "grid_launches": grid_launches, "fast_launches": fast_launches, "kept": kept,
            "n_rays": n_rays, "terminated": terminated, "psnr_cpu": psnrs,
            "psnr_exact": vs_exact}


def phase_fitted_planes(device, ray_args) -> dict:
    """Decode layer 3 of the fitted campaign planes with the same camera by
    the exact tier: a real subject gives a silhouette (mostly saturated acc),
    not noise; a ray subset is re-rendered on the CPU as in phase_decode."""
    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.nerf.renderer import render_image_masked

    ro, rd, near, far, mask, cfg = ray_args
    dec = load_fitted_decoder(device)
    planes = load_fitted_planes(3).to(device=device, dtype=torch.bfloat16)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = render_image_masked(dec, planes, ro, rd, near, far, mask, BOUNDS, cfg)
    sync(device)
    render_s = time.perf_counter() - t0
    launches = kernels.LAUNCHES["fused_decoder"]
    expect_launches(device, launches, 2 * math.ceil(int(mask.sum()) / RENDER_CHUNK),
                    "exact view (fitted)")
    acc = out["acc"].float().cpu().numpy()
    stats = acc_stats(acc, mask)
    say(f"[decode] exact tier, fitted campaign0000 layer 3: {render_s:.3f} s; "
        f"acc {json.dumps(stats)}")
    check(np.isfinite(acc).all(), "non-finite render of the fitted planes")
    check(0.05 <= stats["frac_gt_0.5"] <= 0.95 and stats["frac_saturated"] >= 0.5,
          f"fitted planes give no silhouette: {stats}")
    psnrs = rerender_exact(dec, planes, ray_args, out, "fitted")
    return {"stats": stats, "render_s": render_s, "launches": launches, "planes": planes,
            "rgb": out["rgb"].cpu().numpy(), "psnr": psnrs}


def phase_mesh(device, resolution=MESH_RESOLUTION) -> dict:
    """``extract_mesh`` of the fitted campaign planes (layer 3), as the CLI
    calls it: the density grid on the card, smoothing and marching cubes on
    the host."""
    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.nerf.geometry import eval_density_grid, extract_mesh

    dec = load_fitted_decoder(device)
    planes = load_fitted_planes(3).to(device=device, dtype=torch.bfloat16)
    t0 = time.perf_counter()  # the density grid alone, first (not a path's count)
    eval_density_grid(dec, planes, BOUNDS, resolution=resolution, chunk=MESH_CHUNK)
    grid_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    verts, tris = extract_mesh(dec, planes, BOUNDS, resolution=resolution)
    mesh_s = time.perf_counter() - t0
    launches = kernels.LAUNCHES["fused_decoder"]
    expect_launches(device, launches, math.ceil(resolution ** 3 / MESH_CHUNK),
                    f"mesh (fitted, {resolution}^3)")
    say(f"[mesh] fitted campaign0000 layer 3 at {resolution}^3: {len(verts)} verts, "
        f"{len(tris)} tris in {mesh_s:.3f} s (the density grid alone, evaluated and "
        f"downloaded: {grid_s:.3f} s)")
    check(len(tris) > 0 and np.isfinite(verts).all(), "empty or non-finite mesh")
    check((verts >= BOUNDS[0] - 1e-4).all() and (verts <= BOUNDS[1] + 1e-4).all(),
          "mesh vertices leave the box")
    check(int(tris.min()) >= 0 and int(tris.max()) < len(verts), "triangle indices out of range")
    return {"mesh_s": mesh_s, "grid_s": grid_s, "launches": launches, "verts": len(verts),
            "tris": len(tris)}


def cli_expected_launches(args, samples, device):
    """The fused_decoder launches of the CLI's fast-tier decode of
    ``samples``, worked out apart from it: per sample the grid's chunks, one
    fine tile per 16,384 kept rays of each ``FAST_GROUP`` group of the views'
    in-box rays, and the mesh's chunks. Returns (launches, kept rays, in-box
    rays)."""
    import torch

    from humanliff_tpu_torch.cli.diff_sample import ORBIT_BOUNDS
    from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
    from humanliff_tpu_torch.nerf.fastpath import build_density_grid
    from humanliff_tpu_torch.nerf.renderer import RenderConfig, masked_rays
    from humanliff_tpu_torch.sampling.layered import planes_image_to_triplane

    check(args.fast_render, "the CLI phase decodes by the fast tier")
    dec = load_fitted_decoder(device)
    cams = NovelViewCameras(image_size=args.render_size, cameras_json=args.cameras_json,
                            image_scaling=args.image_scaling)
    items = [cams.rays(v, ORBIT_BOUNDS) for v in range(args.num_views)]
    _, rays, box, _ = masked_rays(
        device, *(np.concatenate([it[k] for it in items])
                  for k in ("rays_o", "rays_d", "near", "far", "ray_mask")),
        ORBIT_BOUNDS, 0.0, ())
    cfg = RenderConfig(n_samples=128, n_importance=128, perturb=False, density_noise=False)
    dtype = torch.bfloat16 if args.render_bf16 else torch.float32
    expected = kept = 0
    with torch.no_grad():
        for sample in samples:
            planes = planes_image_to_triplane(
                torch.from_numpy(sample).to(device=device, dtype=dtype)).contiguous()
            grid = build_density_grid(dec, planes, ORBIT_BOUNDS,
                                      resolution=args.grid_resolution)
            keep = kept_rays(grid, rays, box, cfg, args.early_term_eps)
            per_group = [int(keep[g:g + FAST_GROUP].sum())
                         for g in range(0, keep.shape[0], FAST_GROUP)]
            kept += sum(per_group)
            expected += (math.ceil((args.grid_resolution + 1) ** 3 / GRID_CHUNK)
                         + sum(math.ceil(k / RENDER_CHUNK) for k in per_group)
                         + math.ceil(args.mesh_resolution ** 3 / MESH_CHUNK))
    return expected, kept, len(samples) * rays[0].shape[0]


def phase_cli(device, prev_layer, steps="ddim50", model_kwargs=None, cli_flags=()) -> dict:
    """The sampling CLI as a user calls it, in this process: the seeded UNet
    saved as an uncompressed npz, then ``--layer_idx 3 --sample_npz <layer 2>
    --use_ddim true --decode --report_fidelity`` with the fitted decoder.
    Both live in a temporary directory, removed at the end."""
    import glob

    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.cli import diff_sample
    from humanliff_tpu_torch.mesh.io import read_ply
    from humanliff_tpu_torch.models.factory import create_model_and_diffusion
    from humanliff_tpu_torch.train.checkpoint import load_samples_npz, save_samples_npz

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        with torch.device(device):
            model, _ = create_model_and_diffusion(**(model_kwargs or {}))
        seed_weights(model, 0)
        unet = os.path.join(tmp, "unet.npz")
        t0 = time.perf_counter()
        np.savez(unet, **{k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})
        del model
        say(f"[cli] seeded UNet saved: {os.path.getsize(unet) / 1e9:.3f} GB in "
            f"{time.perf_counter() - t0:.3f} s")
        prev = os.path.join(tmp, "samples_person_pant_shirt.npz")
        save_samples_npz(prev, prev_layer.float().cpu().numpy())
        out_dir = os.path.join(tmp, "out")
        argv = ["--model_npz", unet, "--decoder_npz", DECODER_NPZ, "--out_dir", out_dir,
                "--layer_idx", "3", "--sample_npz", prev, "--num_samples", "1",
                "--use_ddim", "true", "--timestep_respacing", steps, "--decode",
                "--report_fidelity", "--device", device.type, *cli_flags]
        for k, v in (model_kwargs or {}).items():
            argv += [f"--{k}", str(v)]
        args = diff_sample.build_parser().parse_args(argv)
        say(f"[cli] python -m humanliff_tpu_torch.cli.diff_sample {' '.join(argv)}")
        kernels.reset_launches()
        t0 = time.perf_counter()
        diff_sample.main(argv)
        cli_s = time.perf_counter() - t0
        launches = kernels.LAUNCHES["fused_decoder"]

        name = "person_pant_shirt_shoes"
        pngs = glob.glob(os.path.join(out_dir, f"{name}_s0_v*.png"))
        check(len(pngs) == args.num_views, f"{len(pngs)} PNGs, not {args.num_views}")
        samples_path = os.path.join(out_dir, f"samples_{name}.npz")
        check(os.path.exists(samples_path), "no samples npz")
        samples = load_samples_npz(samples_path)
        S, C = args.image_size, args.in_channels
        check(samples.shape == (1, S, S, C) and np.isfinite(samples).all()
              and np.abs(samples).max() <= 1.0 + 1e-5, f"bad samples {samples.shape}")
        fid_path = os.path.join(out_dir, f"fidelity_{name}.json")
        check(os.path.exists(fid_path), "no fidelity json")
        with open(fid_path) as f:
            say(f"[cli] fidelity_{name}.json: {f.read().strip()}")
        ply = os.path.join(out_dir, f"{name}_s0.ply")
        check(os.path.exists(ply), "no PLY")
        verts, tris = read_ply(ply)
        videos = sorted(f for f in os.listdir(out_dir)
                        if f.startswith(f"{name}_s0.") and f.endswith((".mp4", ".avi")))
        say(f"[cli] {cli_s:.3f} s; wrote {len(pngs)} PNGs, {os.path.basename(ply)} "
            f"({len(verts)} verts, {len(tris)} tris), samples_{name}.npz, "
            f"fidelity_{name}.json; video: {', '.join(videos) or 'none written'}")
        expected, kept, n_rays = cli_expected_launches(args, samples, device)
        expect_launches(device, launches, expected,
                        f"cli (grid, {kept} of {n_rays} rays kept in {args.num_views} views, "
                        f"mesh {args.mesh_resolution}^3)")
        return {"cli_s": cli_s, "launches": launches, "tris": len(tris), "videos": videos}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _noise_floor(mu) -> set:
    """Tensors whose gradient is rounding noise: a conv bias ahead of a
    GroupNorm with one channel per group has a gradient of 0 in exact
    arithmetic. They hold under 1e-6 of the whole gradient's norm."""
    floor = 1e-6 * math.sqrt(sum(float(v.double().pow(2).sum()) for v in mu.values()))
    return {n for n, v in mu.items() if float(v.double().norm()) <= floor}


def compare_train_states(got, want, m_got, m_want, lr, label) -> dict:
    """One train step's results on two devices (``got`` on the card, ``want``
    on the CPU; fp32, TF32 off). Bars:

    - metrics rtol 1e-4; sampler counts exact, history rtol 1e-4;
    - the first Adam moment (0.1 x the clipped gradient) per tensor relative
      L2 1e-4, the second 2e-4; noise-floor tensors (``_noise_floor``) under
      1e-5 of the gradient's norm on both sides;
    - params and EMA: a first Adam step is lr x g / (|g| + eps), about lr x
      sign(g), so an element whose gradient's sign differs in the last bits
      moves 2 x lr apart. All within 2 x lr (x (1 - rate) for an EMA); at
      most 1e-4 of the elements of tensors off the noise floor beyond 1e-2 x
      lr (an H100 at 700 W: 27 of 912,603, 0.35 x lr the farthest).
    """
    import torch

    def sd(state, flat):
        return {k: v.detach().double().cpu() for k, v in state.layout.views(flat).items()}

    out = {}
    for k in m_want:
        a, b = float(m_got[k]), float(m_want[k])
        check(abs(a - b) <= 1e-4 * abs(b) + 1e-7, f"{label}: metric {k} {a} vs {b}")
        out[f"metric_{k}"] = abs(a - b) / max(abs(b), 1e-30)
    mu_w = sd(want, want.opt_state["mu"])
    noise = _noise_floor(mu_w)
    total = math.sqrt(sum(float(v.pow(2).sum()) for v in mu_w.values()))
    for key, bar in (("mu", 1e-4), ("nu", 2e-4)):
        a, b = sd(got, got.opt_state[key]), sd(want, want.opt_state[key])
        worst = 0.0
        for n in b:
            if n in noise:
                check(key == "nu" or float(a[n].norm()) <= 1e-5 * total,
                      f"{label}: {n} off the noise floor on the card")
                continue
            rel = float((a[n] - b[n]).norm() / b[n].norm().clamp(min=1e-30))
            check(rel <= bar, f"{label}: Adam {key} of {n}: relative L2 {rel:.3e} > {bar}")
            worst = max(worst, rel)
        out[f"{key}_rel_l2"] = worst
    rates = sorted(want.ema_params)
    for what, a, b, scale in ([("params", sd(got, got.params), sd(want, want.params), 1.0)]
                              + [(f"ema {r}", sd(got, got.ema_params[r]),
                                  sd(want, want.ema_params[r]), 1.0 - float(r)) for r in rates]):
        n_off = n_all = 0
        worst = 0.0
        for n in b:
            d = (a[n] - b[n]).abs()
            worst = max(worst, float(d.max()) / (lr * scale))
            check(float(d.max()) <= 2 * lr * scale + 1e-7, f"{label}: {what} {n} moved apart")
            if n not in noise:
                n_off += int((d > 1e-2 * lr * scale + 1e-9).sum())
                n_all += d.numel()
        check(n_off <= 1e-4 * n_all, f"{label}: {what}: {n_off} of {n_all} elements apart")
        out[f"{what}_max_over_lr"] = worst
        out[f"{what}_elements_apart"] = n_off
    if want.sampler_state is not None:
        check(torch.equal(got.sampler_state["counts"].cpu(), want.sampler_state["counts"]),
              f"{label}: sampler counts differ")
        h_a, h_b = got.sampler_state["history"].cpu(), want.sampler_state["history"]
        check(torch.allclose(h_a, h_b, rtol=1e-4, atol=1e-7), f"{label}: sampler history differs")
    return out


def _small_step_card_vs_cpu(device) -> dict:
    """Check 1: one fp32 step at image 16, 32 channels, batch 4 in
    microbatches of 2, the loss-aware sampler warmed, t and noise injected,
    on the card and on the CPU."""
    import copy

    import torch

    from humanliff_tpu_torch.models.factory import create_model_and_diffusion
    from humanliff_tpu_torch.train.stage2 import Stage2Config, create_stage2_state, train_step

    kw = dict(image_size=16, num_channels=32, num_res_blocks=1, attention_resolutions="8",
              num_heads=2)
    model, diffusion = create_model_and_diffusion(**kw)
    seed_weights(model, 0)
    cfg = Stage2Config(lr=1e-3, microbatch=2, ema_rates=(0.9, 0.9999),
                       schedule_sampler="loss-second-moment")
    rng = np.random.default_rng(4)
    T = diffusion.num_timesteps
    sampler = {"history": torch.from_numpy(rng.uniform(0.1, 2.0, (T, 10)).astype(np.float32)),
               "counts": torch.full((T,), 10, dtype=torch.int32)}
    batch = {"x": torch.from_numpy(rng.normal(scale=0.4, size=(4, 16, 16, 27)).astype(np.float32)),
             "x_cond": torch.from_numpy(rng.normal(scale=0.4, size=(4, 16, 16, 27))
                                        .astype(np.float32)),
             "y": torch.tensor([0, 1, 2, 3])}
    t = torch.tensor([3, 250, 251, 990])
    noise = torch.from_numpy(rng.standard_normal((4, 16, 16, 27)).astype(np.float32))
    runs = []
    for dev in (device, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev)
        state = create_stage2_state(m, cfg, T)
        state.sampler_state = {k: v.to(dev) for k, v in sampler.items()}
        metrics = train_step(state, m, diffusion, cfg, {k: v.to(dev) for k, v in batch.items()},
                             t=t.to(dev), noise=noise.to(dev))
        runs.append((state, metrics))
    errs = compare_train_states(runs[0][0], runs[1][0], runs[0][1], runs[1][1], cfg.lr,
                                "train small card vs cpu")
    say(f"[train] check 1, image 16 / 32 channels, one fp32 step, card vs CPU: "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}")
    return errs


class StepTimer:
    """Wraps ``train_step``: each call between two synchronizes, timed by the
    host clock and by CUDA events; call ``profile_at`` runs under
    torch.profiler, for the device's busy share."""

    def __init__(self, fn, device, profile_at: int):
        self.fn, self.device, self.profile_at = fn, device, profile_at
        self.wall, self.event_ms, self.kernel_ms, self.kernels = [], [], None, None
        self.top = []

    def __call__(self, *args, **kwargs):
        import contextlib

        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        sync(self.device)
        i = len(self.wall)
        prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                if cuda and i == self.profile_at else contextlib.nullcontext())
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        with prof:
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            if cuda:
                end.record()
            sync(self.device)
            self.wall.append(time.perf_counter() - t0)
        if cuda:
            self.event_ms.append(start.elapsed_time(end))
        if prof is not None and i == self.profile_at and cuda:
            on_device = [e for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
            self.kernel_ms = sum(device_us(e) for e in on_device) / 1e3
            self.kernels = sum(e.count for e in on_device)
            # Operators by the device time of the kernels they launched.
            ops = [e for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CUDA and device_us(e) > 0]
            self.top = [(e.key[:60], device_us(e) / 1e3, e.count)
                        for e in sorted(ops, key=device_us, reverse=True)[:10]]
        return out


def device_us(evt) -> float:
    """A profiler event's own device time, microseconds (the attribute's name
    changed across torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def phase_train(device, model_kwargs=None, planes=None, steps=20, batch_size=8,
                microbatch=2, descent_steps=10) -> dict:
    """Stage-2 training's five checks (module docstring). ``planes`` (1, L,
    3, C3, S, S) defaults to the fitted campaign planes; the model, the two
    checkpoints (about 8 GB and 4 GB at the flagship width) and the samples
    live in a temporary directory, removed at the end."""
    import statistics

    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.cli import diff_sample, diff_train
    from humanliff_tpu_torch.data.triplane_data import pack_subject_planes
    from humanliff_tpu_torch.models.factory import create_model_and_diffusion
    from humanliff_tpu_torch.train import checkpoint as ckpt
    from humanliff_tpu_torch.train.stage2 import Stage2Config, create_stage2_state, train_step

    out = {"small": _small_step_card_vs_cpu(device)}
    model_kwargs = dict(model_kwargs or {})
    flags = [x for k, v in model_kwargs.items() for x in (f"--{k}", str(v))]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # Check 2: the CLI at the flagship width on the fitted planes.
        packed = os.path.join(tmp, "planes.npy")
        src = PLANES_NPZ
        if planes is not None:
            src = os.path.join(tmp, "subject_000000.npz")
            ckpt.save_subject_planes(src, planes[0], 0)
        pack_subject_planes([src], packed)
        logdir = os.path.join(tmp, "run")
        base = ["--data_dir", packed, "--batch_size", str(batch_size), "--microbatch",
                str(microbatch), "--log_interval", str(steps // 2), "--save_interval",
                str(steps), "--logdir", logdir, "--device", device.type, *flags]
        argv = base + ["--total_steps", str(steps)]
        say(f"[train] python -m humanliff_tpu_torch.cli.diff_train {' '.join(argv)}")
        # The profiled step is the third, a warm-up step left out of the
        # median, inside the first log interval with the first two.
        timer = StepTimer(diff_train.train_step, device, profile_at=2)
        saves = []
        real_save = ckpt.save_state

        def timed_save(ckpt_dir, step, state):
            t0 = time.perf_counter()
            path = real_save(ckpt_dir, step, state)
            saves.append((step, time.perf_counter() - t0,
                          os.path.getsize(os.path.join(path, ckpt.STATE_FILE)) / 1e9))
            return path

        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        diff_train.train_step, ckpt.save_state = timer, timed_save
        try:
            t0 = time.perf_counter()
            diff_train.main(argv)
            train_s = time.perf_counter() - t0
        finally:
            diff_train.train_step, ckpt.save_state = train_step, real_save
        launches = kernels.LAUNCHES.get("fused_decoder", 0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None
        with open(os.path.join(logdir, "progress.json")) as f:
            logs = [json.loads(line) for line in f]
        for m in logs:
            say(f"[train] step {m['step']}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, "
                f"loss_q0..3 {', '.join(f'{m[f'loss_q{q}']:.4f}' for q in range(4))}, "
                f"steps/s {m['steps_per_sec']:.4f}")
        check(len(logs) == 2 and all(math.isfinite(v) for m in logs for v in m.values()),
              f"non-finite or missing training logs: {logs}")
        steady = timer.wall[3:]
        wall_s = statistics.median(steady)
        rec = {"steps": steps, "train_s": train_s, "wall_s_per_step": wall_s,
               "wall_s_all": timer.wall, "peak_gb": peak_gb, "saves": saves,
               "losses": [m["loss"] for m in logs], "launches": launches}
        if device.type == "cuda":
            rec.update(event_ms_per_step=statistics.median(timer.event_ms[3:]),
                       kernel_ms=timer.kernel_ms,
                       kernels=timer.kernels, busy=timer.kernel_ms / (1e3 * wall_s))
            say(f"[train] check 2, flagship width: {steps} steps in {train_s:.3f} s; s/step "
                f"(median of steps 4-{steps}) {wall_s:.4f}; device ms/step by CUDA "
                f"events {rec['event_ms_per_step']:.3f}; profiled step {timer.profile_at + 1}: "
                f"{timer.kernel_ms:.3f} ms of kernels ({timer.kernels} launches), busy share "
                f"{rec['busy']:.4f}; peak memory {peak_gb:.3f} GB")
            say("[train] profiled step, operators by kernel ms (ms, calls): "
                + "; ".join(f"{k} {ms:.3f} ({n})" for k, ms, n in timer.top))
        say(f"[train] saves (step, s, GB): {saves}; per-step wall s: "
            f"{', '.join(f'{w:.4f}' for w in timer.wall)}")
        check(saves and saves[-1][0] == steps, f"no final save at step {steps}: {saves}")

        # Checks 4 and 3 at the same width on one fixed batch of the fitted
        # planes, t and noise: bf16 against fp32 with seeded weights in every
        # layer (at PyTorch's initialisation the zero-initialised output conv
        # makes both outputs 0), then descent from that initialisation.
        with torch.device(device):
            model, diffusion = create_model_and_diffusion(**model_kwargs)
        seed_weights(model, 0)
        planes_t = torch.from_numpy(np.load(packed)[0]).to(device)  # (L, C, S, S)
        planes_t = planes_t.permute(0, 2, 3, 1).contiguous()  # NHWC
        L, S, C = planes_t.shape[0], planes_t.shape[1], planes_t.shape[3]
        idx = torch.arange(batch_size, device=device) % L
        batch = {"planes": planes_t, "idx": idx, "y": idx % L}
        g = torch.Generator(device=device).manual_seed(7)
        t = torch.randint(0, diffusion.num_timesteps, (batch_size,), generator=g, device=device)
        noise = torch.randn(batch_size, S, S, C, generator=g, device=device)
        grads = {}
        for bf16 in (True, False):  # lr 0 and no clipping: state.grads are the raw gradients
            cfg = Stage2Config(lr=0.0, microbatch=microbatch, grad_clip_value=0.0,
                               grad_clip_norm=0.0, use_bf16=bf16)
            state = create_stage2_state(model, cfg, diffusion.num_timesteps)
            m = train_step(state, model, diffusion, cfg, batch, t=t, noise=noise)
            grads[bf16] = (float(m["loss"]), state.grads.double())
            del state
        loss_rel = abs(grads[True][0] - grads[False][0]) / abs(grads[False][0])
        g16, g32 = grads[True][1], grads[False][1]
        grad_rel = float((g16 - g32).norm() / g32.norm())
        del grads, g16, g32
        say(f"[train] check 4, bf16 vs fp32 (TF32 off), one flagship step: loss "
            f"{loss_rel:.4e} relative (bar {BF16_LOSS_REL}), gradients relative L2 "
            f"{grad_rel:.4e} (bar {BF16_GRAD_REL})")
        check(loss_rel <= BF16_LOSS_REL and grad_rel <= BF16_GRAD_REL,
              f"bf16 step disagrees with fp32: loss {loss_rel}, gradients {grad_rel}")
        del model
        torch.manual_seed(0)
        with torch.device(device):
            model, diffusion = create_model_and_diffusion(**model_kwargs)
        cfg = Stage2Config(lr=5e-5, microbatch=microbatch, use_bf16=True)
        state = create_stage2_state(model, cfg, diffusion.num_timesteps)
        losses = [float(train_step(state, model, diffusion, cfg, batch, t=t, noise=noise)["loss"])
                  for _ in range(descent_steps + 1)]
        drop = 1.0 - losses[-1] / losses[0]
        say(f"[train] check 3, descent on a fixed batch: loss {losses[0]:.6f} -> "
            f"{losses[-1]:.6f} after {descent_steps} steps ({drop:.4%}; bar "
            f"{DESCENT_MIN_DROP:.2%}): {', '.join(f'{v:.6f}' for v in losses)}")
        check(all(math.isfinite(v) for v in losses) and drop >= DESCENT_MIN_DROP,
              f"the loss did not descend: {losses}")
        del state, model
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # Check 5: resume for a 21st step, the restore checked against the
        # file bit for bit, then sample from its (light) checkpoint.
        restored_ok = []
        real_restore = diff_train.restore_into

        def checked_restore(state, restored):
            full = real_restore(state, restored)
            views = state.layout.views
            pairs = [(views(state.params), restored["params"])]
            pairs += [(views(state.ema_params[r]), restored["ema_params"][r])
                      for r in restored["ema_params"]]
            if full:
                pairs += [(views(state.opt_state[k]), restored["opt_state"][k])
                          for k in ("mu", "nu")]
            same = all(torch.equal(a[n], b[n].to(a[n].device)) for a, b in pairs for n in b)
            same &= (not full) or state.opt_state["count"] == restored["opt_state"]["count"]
            restored_ok.append((full, same))
            return full

        diff_train.restore_into = checked_restore
        try:
            resumed = diff_train.main(base + ["--total_steps", str(steps + 1),
                                              "--light_final_save", "true"])
        finally:
            diff_train.restore_into = real_restore
        say(f"[train] check 5, resumed at step {steps}: restore (full, bit for bit) "
            f"{restored_ok}; now at step {resumed.step}")
        check(restored_ok == [(True, True)] and resumed.step == steps + 1,
              f"resume failed: {restored_ok}, step {resumed.step}")
        del resumed
        sample_dir = os.path.join(tmp, "samples")
        sargv = ["--model_dir", logdir, "--timestep_respacing", "ddim2", "--use_ddim", "true",
                 "--num_samples", "1", "--out_dir", sample_dir, "--device", device.type, *flags]
        say(f"[train] python -m humanliff_tpu_torch.cli.diff_sample {' '.join(sargv)}")
        t0 = time.perf_counter()
        diff_sample.main(sargv)
        sample_s = time.perf_counter() - t0
        samples = ckpt.load_samples_npz(os.path.join(sample_dir, "samples_person.npz"))
        say(f"[train] sampled layer person from step {steps + 1} in {sample_s:.3f} s: "
            f"{samples.shape}, range [{samples.min():.4f}, {samples.max():.4f}]")
        check(np.isfinite(samples).all() and np.abs(samples).max() <= 1.0 + 1e-5,
              "samples of the trained model are not finite in [-1, 1]")
        rec.update(loss_rel_bf16=loss_rel, grad_rel_bf16=grad_rel, descent=losses,
                   descent_drop=drop, sample_s=sample_s)
        out["flagship"] = rec
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# Stage 1: recon_train, recon_ft, recon_test and the eval harness
# --------------------------------------------------------------------------


def stage1_fixture_planes(n: int, layers: int, D: int, seed: int = 0) -> np.ndarray:
    """(n, layers, 3, 9, D, D): noise plus a central blob, so that rays meet
    density (the planes of tests/torch_stage1_util.py)."""
    rng = np.random.default_rng(seed)
    g = (np.arange(D) + 0.5) / D * 2 - 1
    u, v = np.meshgrid(g, g, indexing="xy")
    blob = np.exp(-3.0 * (u ** 2 + v ** 2))
    return (0.3 * rng.normal(size=(n, layers, 3, 9, D, D)) + 0.8 * blob).astype(np.float32)


def stage1_batch(ds, items, device) -> dict:
    """A batch of ``ds.item(index, default_rng(seed))`` for (index, seed) in
    ``items``, on ``device`` (``recon_train.to_device``)."""
    from humanliff_tpu_torch.cli.recon_train import to_device

    its = [ds.item(int(i), np.random.default_rng(int(s))) for i, s in items]
    return to_device({k: np.stack([it[k] for it in its]) for k in its[0]}, device)


def near_zero_apart(got, want, grad, lr: float, label: str) -> dict:
    """One Adam step's parameters on two devices. An element whose gradient
    is under RECON_NEAR_ZERO_GRAD (100 x Adam's eps) steps by lr x g / (|g| +
    eps), whose size reads the gradient's last bits: it may sit up to 2 lr
    apart. Every other element within RECON_STEP_APART x lr, but for at most
    1e-4 of them (a gradient near 0 that takes the other sign), within 2 lr."""
    d = (got.detach().double().cpu() - want.detach().double().cpu()).abs()
    near = grad.detach().cpu().abs() < RECON_NEAR_ZERO_GRAD
    check(float(d.max()) <= 2 * lr + 1e-7, f"{label}: {float(d.max())} apart, over 2 lr")
    off = int(((d > RECON_STEP_APART * lr) & ~near).sum())
    check(off <= 1e-4 * d.numel(), f"{label}: {off} of {d.numel()} elements apart")
    far = d[~near]
    return {"max_over_lr": float(d.max()) / lr, "near_zero": int(near.sum()),
            "other_max_over_lr": float(far.max()) / lr if far.numel() else 0.0,
            "other_apart": off, "of": d.numel()}


def small_step_card_vs_cpu(device, cfg, planes, batch_fn, label: str, body_model=None) -> dict:
    """One deterministic Stage-1 step from ``planes`` and the fitted decoder
    on the card and on the CPU, on ``batch_fn(device)``: metrics within
    RECON_SMALL_METRIC_REL, each group's first moment within
    RECON_SMALL_MOMENT_REL, parameters by near_zero_apart."""
    import torch

    from humanliff_tpu_torch.nerf.decoder import flatten_state_dict
    from humanliff_tpu_torch.train.optim import make_stage1_optimizer
    from humanliff_tpu_torch.train.stage1 import create_train_state, train_step

    flat = flatten_state_dict(load_fitted_decoder("cpu").state_dict())
    runs = []
    for dev in (device, torch.device("cpu")):
        state = create_train_state({"planes": planes.to(dev, copy=True),
                                    "decoder": flat.to(dev, copy=True)},
                                   make_stage1_optimizer())
        aux = train_step(state, batch_fn(dev), cfg, body_model=body_model)
        runs.append((state, {k: float(v) for k, v in aux.items()}))
    (card, m_card), (cpu, m_cpu) = runs
    out = {}
    for k, v in m_cpu.items():
        rel = abs(m_card[k] - v) / max(abs(v), 1e-30)
        check(rel <= RECON_SMALL_METRIC_REL, f"{label}: {k} {m_card[k]} vs {v}")
        out[f"metric_{k}"] = rel
    for group, lr in (("planes", 1e-1), ("decoder", 5e-3)):
        mu_card, mu_cpu = card.opt_state[group]["mu"], cpu.opt_state[group]["mu"]
        rel = float((mu_card.double().cpu() - mu_cpu.double()).norm() / mu_cpu.double().norm())
        check(rel <= RECON_SMALL_MOMENT_REL, f"{label}: {group} first moment {rel}")
        out[f"{group}_mu_rel_l2"] = rel
        # After one step the first moment is 0.1 x the gradient.
        out[group] = near_zero_apart(card.params[group], cpu.params[group], mu_cpu / 0.1, lr,
                                     f"{label} {group}")
    return out


def _recon_small_card_vs_cpu(device) -> dict:
    """Check 1: one deterministic Stage-1 step at a small width (2 instances,
    4 layers, D 32, 64 rays, 16 + 16 samples, the fitted decoder) on the card
    and on the CPU."""
    import torch

    from humanliff_tpu_torch.data.synthetic import SyntheticLayeredDataset
    from humanliff_tpu_torch.nerf.renderer import RenderConfig
    from humanliff_tpu_torch.train.stage1 import Stage1Config

    cfg = Stage1Config(num_instances=2, triplane_dim=32,
                       render=RenderConfig(n_samples=16, n_importance=16, perturb=False,
                                           density_noise=False))
    ds = SyntheticLayeredDataset(num_instances=2, n_rays=64, image_size=32, tight_bounds=True)
    items = [(1 * 64 + 3, 1), (256 + 3 * 64 + 17, 2)]  # (0, layer 1), (1, layer 3)
    out = small_step_card_vs_cpu(device, cfg, torch.from_numpy(stage1_fixture_planes(2, 4, 32)),
                                 lambda dev: stage1_batch(ds, items, dev), "recon small")
    say(f"[recon] check 1, one step at D 32 / 64 rays / 16 + 16 samples, card vs CPU: "
        f"{json.dumps(out)}")
    return out


def _recon_descent_and_cache(device, steps: int = 10, D: int = 256, n_rays: int = 2048,
                             samples: int = 128, probe_points: int = 1 << 16) -> dict:
    """Checks 3 and 4: ``steps`` deterministic steps on one fixed batch at
    the full width (2 instances), the loss falling by RECON_DESCENT_MIN_DROP;
    after every step the kernel, through the packed-weight cache, against
    decoder_plain of the current weights on fixed probe inputs."""
    import torch
    import torch.nn.functional as F

    from humanliff_tpu_torch.data.synthetic import SyntheticLayeredDataset
    from humanliff_tpu_torch.nerf.decoder import FlatDecoder
    from humanliff_tpu_torch.nerf.renderer import RenderConfig
    from humanliff_tpu_torch.ops.fused_decoder import decoder_plain, fused_decoder
    from humanliff_tpu_torch.ops.triplane import sample_triplane_features
    from humanliff_tpu_torch.train.optim import make_stage1_optimizer
    from humanliff_tpu_torch.train.stage1 import (
        Stage1Config,
        create_train_state,
        init_params,
        train_step,
    )

    cfg = Stage1Config(num_instances=2, triplane_dim=D,
                       render=RenderConfig(n_samples=samples, n_importance=samples,
                                           perturb=False, density_noise=False))
    state = create_train_state(init_params(cfg, seed=0, device=device), make_stage1_optimizer())
    ds = SyntheticLayeredDataset(num_instances=2, n_rays=n_rays, image_size=128,
                                 tight_bounds=True)
    batch = stage1_batch(ds, [(3, 21), (256 + 2 * 64 + 9, 22)], device)
    fitted = load_fitted_planes(3).to(device)
    box = torch.from_numpy(BOUNDS).to(device)
    gen = torch.Generator(device=device).manual_seed(5)
    coords = torch.rand(probe_points, 3, generator=gen, device=device) * (box[1] - box[0]) + box[0]
    feats = sample_triplane_features(fitted, coords, box).contiguous()
    dirs = F.normalize(torch.randn(probe_points, 3, generator=gen, device=device), dim=-1)
    losses, errs, prev = [], [], None
    for _ in range(steps + 1):
        losses.append(float(train_step(state, batch, cfg)["loss"]))
        with torch.no_grad():
            w = FlatDecoder(state.params["decoder"]).weights()
            rgb, alpha = fused_decoder(w, feats, dirs)
            ref_rgb, ref_alpha = decoder_plain(w, feats, dirs)
        sync(device)
        scale = max(float(ref_rgb.abs().max()), float(ref_alpha.abs().max()))
        err = max(float((rgb - ref_rgb).abs().max()), float((alpha - ref_alpha).abs().max()))
        tol = 1e-4 + 1e-5 * scale  # the kernel phase's fp32 bar
        check(err <= tol, f"recon: after step {len(losses)} the kernel is {err} from "
                          f"decoder_plain of the current weights (tol {tol})")
        if prev is not None:
            check(float((rgb - prev).abs().max()) > 0.0,
                  f"recon: the kernel's output did not change at step {len(losses)}")
        prev = rgb
        errs.append(err)
    drop = 1.0 - losses[-1] / losses[0]
    say(f"[recon] check 3, descent on a fixed batch (D {D}, {n_rays} rays x 2, {samples} + "
        f"{samples} samples): loss {losses[0]:.6f} -> {losses[-1]:.6f} after {steps} steps "
        f"({drop:.4%}; bar {RECON_DESCENT_MIN_DROP:.2%}): "
        f"{', '.join(f'{v:.6f}' for v in losses)}")
    say(f"[recon] check 4, kernel vs decoder_plain of the current weights after each step "
        f"({probe_points} points): max abs err {', '.join(f'{e:.3e}' for e in errs)}")
    check(all(math.isfinite(v) for v in losses) and drop >= RECON_DESCENT_MIN_DROP,
          f"the Stage-1 loss did not descend: {losses}")
    return {"losses": losses, "drop": drop, "cache_errs": errs}


def _recon_eval_committed(device, views=None) -> dict:
    """Check 6: evaluate_views (exact tier) on the committed fitted pair at
    the reference's image size, per (subject, layer, view) against the JAX
    package's numbers (STAGE1_REFERENCE), and the pair's deterministic
    stage1_loss on the reference's fixed batch. ``views`` limits the views
    (a CPU rehearsal); the launches are the views' only."""
    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.data.synthetic import SyntheticLayeredDataset
    from humanliff_tpu_torch.eval.harness import evaluate_views
    from humanliff_tpu_torch.nerf.decoder import flatten_state_dict
    from humanliff_tpu_torch.nerf.renderer import RenderConfig
    from humanliff_tpu_torch.train.stage1 import Stage1Config, stage1_loss

    with open(STAGE1_REFERENCE) as f:
        ref = json.load(f)
    dec = load_fitted_decoder(device)
    planes = []
    for path in (PLANES_NPZ, PLANES_NPZ_1):
        with np.load(path) as z:
            planes.append(torch.from_numpy(np.ascontiguousarray(z["tri_planes"])).to(device))
    cfg = RenderConfig(n_samples=ref["n_samples"], n_importance=ref["n_importance"],
                       perturb=False, density_noise=False)
    S = ref["image_size"]
    ds = SyntheticLayeredDataset(num_instances=2, n_rays=ref["batch"]["n_rays"], image_size=S,
                                 tight_bounds=True)
    keys = list(ref["eval"]) if views is None else list(views)
    gaps, expected = {}, 0
    kernels.reset_launches()
    t0 = time.perf_counter()
    for key in keys:
        subject, layer, view = (int(part[1:]) for part in key.split("_"))
        item = ds.test_item(subject, layer, view)
        expected += 2 * math.ceil(int(item["ray_mask"].sum()) / ref["chunk"])
        agg = evaluate_views(dec, planes[subject][layer], [item], cfg, chunk=ref["chunk"],
                             tag=key)
        gaps[key] = agg["psnr"] - ref["eval"][key]["psnr"]
    sync(device)
    eval_s = time.perf_counter() - t0
    launches = kernels.LAUNCHES["fused_decoder"]
    worst = max(gaps, key=lambda k: abs(gaps[k]))
    say(f"[recon] check 6, eval of the committed pair ({len(keys)} views at {S}^2, exact "
        f"tier) in {eval_s:.3f} s: PSNR card - JAX CPU per view (bar {RECON_EVAL_PSNR_DB} dB) "
        + ", ".join(f"{k} {ref['eval'][k]['psnr']:.4f}{gaps[k]:+.5f}" for k in keys))
    check(abs(gaps[worst]) <= RECON_EVAL_PSNR_DB,
          f"recon eval: {worst} is {gaps[worst]:+.4f} dB from the JAX CPU reference")

    scfg = Stage1Config(num_instances=2, render=cfg, tv_loss_coef=ref["batch"]["tv_loss_coef"],
                        l1_loss_coef=ref["batch"]["l1_loss_coef"],
                        acc_loss_coef=ref["batch"]["acc_loss_coef"])
    params = {"planes": torch.stack(planes), "decoder": flatten_state_dict(dec.state_dict(),
                                                                           device)}
    with torch.no_grad():
        loss, aux = stage1_loss(params, stage1_batch(ds, ref["batch"]["items"], device), scfg)
    loss_rel = abs(float(loss) - ref["loss"]) / ref["loss"]
    say(f"[recon] check 6, stage1_loss of the pair on the reference batch: {float(loss):.8f} "
        f"vs JAX CPU {ref['loss']:.8f}: {loss_rel:.3e} relative (bar {RECON_LOSS_REL}); psnr "
        f"{float(aux['psnr']):.4f} vs {ref['aux']['psnr']:.4f}")
    check(loss_rel <= RECON_LOSS_REL, f"recon: the pair's loss is {loss_rel} from JAX's")
    return {"launches": launches, "expected": expected, "psnr_gaps": gaps,
            "max_abs_gap_db": abs(gaps[worst]), "loss_rel": loss_rel, "eval_s": eval_s}


def phase_recon(device, steps: int = 20, cli_flags=(), ft_steps: int = 3, descent=None,
                eval_views=None) -> dict:
    """Stage 1's seven checks (module docstring). ``cli_flags`` are added to
    the three CLIs' (a CPU rehearsal shrinks the width with them), ``descent``
    to _recon_descent_and_cache's arguments, ``eval_views`` limits check 6.
    The run directory (about 8.5 GB of checkpoint at the flagship width)
    lives in a temporary directory, removed at the end."""
    import statistics

    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.cli import recon_ft, recon_test, recon_train
    from humanliff_tpu_torch.data.triplane_data import TriplaneDataset, pack_subject_planes
    from humanliff_tpu_torch.eval.harness import default_test_views
    from humanliff_tpu_torch.train import checkpoint as ckpt
    from humanliff_tpu_torch.train.stage1 import train_step
    from humanliff_tpu_torch.utils.config import parse_with_config

    out = {"small": _recon_small_card_vs_cpu(device)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recon_")
    try:
        # Check 2: the training CLI at the flagship width.
        common = ["--config", SYNBODY_CONFIG, "--data_set_type", "synthetic",
                  "--synthetic_image_size", "128", "--synthetic_tight_bounds", "true",
                  "--basedir", tmp, "--expname", "run", "--device", device.type, *cli_flags]
        argv = common + ["--n_iteration", str(steps), "--i_print", str(steps // 2)]
        say(f"[recon] python -m humanliff_tpu_torch.cli.recon_train {' '.join(argv)}")
        timer = StepTimer(recon_train.train_step, device, profile_at=2)
        saves = []
        real_save = ckpt.save_state

        def timed_save(ckpt_dir, step, state):
            t0 = time.perf_counter()
            path = real_save(ckpt_dir, step, state)
            saves.append((step, time.perf_counter() - t0,
                          os.path.getsize(os.path.join(path, ckpt.STATE_FILE)) / 1e9))
            return path

        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        recon_train.train_step, ckpt.save_state = timer, timed_save
        try:
            t0 = time.perf_counter()
            state = recon_train.main(argv)
            train_s = time.perf_counter() - t0
        finally:
            recon_train.train_step, ckpt.save_state = train_step, real_save
        launches = kernels.LAUNCHES["fused_decoder"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None
        table_gb = state.params["planes"].numel() * 4 / 1e9
        del state
        with open(os.path.join(tmp, "run", "progress.json")) as f:
            logs = [json.loads(line) for line in f]
        for m in logs:
            say(f"[recon] step {m['step']}: loss {m['loss']:.6f}, psnr {m['psnr']:.4f}, "
                f"time_per_iter {m['time_per_iter']:.4f} s, loader_wait_per_iter "
                f"{m['loader_wait_per_iter']:.4f} s")
        check(len(logs) == 2 and all(math.isfinite(v) for m in logs for v in m.values()),
              f"non-finite or missing Stage-1 logs: {logs}")
        wall_s = statistics.median(timer.wall[3:])
        rec = {"steps": steps, "train_s": train_s, "wall_s_per_step": wall_s,
               "wall_s_all": timer.wall, "peak_gb": peak_gb, "table_gb": table_gb,
               "saves": saves, "losses": [m["loss"] for m in logs],
               "loader_wait_per_iter": [m["loader_wait_per_iter"] for m in logs],
               "launches": launches}
        if device.type == "cuda":
            rec.update(event_ms_per_step=statistics.median(timer.event_ms[3:]),
                       kernel_ms=timer.kernel_ms, kernels=timer.kernels,
                       busy=timer.kernel_ms / (1e3 * wall_s))
            say(f"[recon] check 2, flagship width: {steps} steps in {train_s:.3f} s; s/step "
                f"(median of steps 4-{steps}) {wall_s:.4f}; device ms/step by CUDA events "
                f"{rec['event_ms_per_step']:.3f}; profiled step {timer.profile_at + 1}: "
                f"{timer.kernel_ms:.3f} ms of kernels ({timer.kernels} launches), busy share "
                f"{rec['busy']:.4f}; peak memory {peak_gb:.3f} GB (table {table_gb:.3f} GB)")
            say("[recon] profiled step, operators by kernel ms (ms, calls): "
                + "; ".join(f"{k} {ms:.3f} ({n})" for k, ms, n in timer.top))
        say(f"[recon] saves (step, s, GB): {saves}; per-step wall s: "
            f"{', '.join(f'{w:.4f}' for w in timer.wall)}")
        check(saves and saves[-1][0] == steps, f"no final save at step {steps}: {saves}")
        expect_launches(device, launches, 2 * steps,
                        f"recon_train ({steps} steps: the coarse and the fine pass each)")
        out["flagship"] = rec

        out["descent"] = _recon_descent_and_cache(device, **(descent or {}))

        # Check 5: the fine-tune of subject 0 from the saved state.
        captured = {}
        real_load = recon_ft.load_shared

        def capture(expdir, dev):
            shared = real_load(expdir, dev)
            captured.update(decoder=shared["decoder"], before=shared["decoder"].clone())
            return shared

        ft_dir = os.path.join(tmp, "planes")
        ft_argv = common + ["--ft_steps", str(ft_steps), "--start_idx", "0", "--end_idx", "1",
                            "--out_dir", ft_dir]
        say(f"[recon] python -m humanliff_tpu_torch.cli.recon_ft {' '.join(ft_argv)}")
        recon_ft.load_shared = capture
        kernels.reset_launches()
        try:
            t0 = time.perf_counter()
            recon_ft.main(ft_argv)
            ft_s = time.perf_counter() - t0
        finally:
            recon_ft.load_shared = real_load
        ft_launches = kernels.LAUNCHES["fused_decoder"]
        same = torch.equal(captured["decoder"], captured["before"])
        export = os.path.join(ft_dir, "subject0000_002000.npz")
        packed = pack_subject_planes([export], os.path.join(tmp, "packed.npy"))
        item = TriplaneDataset(os.path.join(tmp, "packed.npy")).item(3)
        say(f"[recon] check 5, recon_ft of subject 0 ({ft_steps} steps x 4 layers) in "
            f"{ft_s:.3f} s: decoder bit for bit {same}; export packs to {packed.shape}, "
            f"item 3: x {item['x'].shape}, y {int(item['y'])}")
        check(same, "recon_ft moved the frozen decoder")
        check(np.isfinite(packed).all() and packed.shape[:2] == (1, 4) and int(item["y"]) == 3,
              "the fine-tune's export does not pack for Stage 2")
        expect_launches(device, ft_launches, 2 * 4 * ft_steps, "recon_ft")
        out["ft"] = {"launches": ft_launches, "seconds": ft_s}

        out["eval"] = _recon_eval_committed(device, eval_views)
        expect_launches(device, out["eval"]["launches"], out["eval"]["expected"], "recon eval")

        # Check 7: recon_test of subject 0 with the fine-tune's planes.
        test_argv = common + ["--triplane_dir", ft_dir, "--start_idx", "0", "--end_idx", "1",
                              "--savedir", os.path.join(tmp, "test")]
        say(f"[recon] python -m humanliff_tpu_torch.cli.recon_test {' '.join(test_argv)}")
        # The CLI's own dataset gives the held-out views' ray masks.
        ds, _ = recon_train.build_dataset(parse_with_config(recon_test.build_parser(), test_argv))
        expected = sum(2 * math.ceil(int(ds.test_item(0, layer, view)["ray_mask"].sum()) / 4096)
                       for layer in range(4) for view in default_test_views(layer))
        kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = recon_test.main(test_argv)
        test_s = time.perf_counter() - t0
        test_launches = kernels.LAUNCHES["fused_decoder"]
        say(f"[recon] check 7, recon_test in {test_s:.3f} s: "
            + "; ".join(f"{k} psnr {m['psnr']:.3f} ssim {m['ssim']:.4f}"
                        for k, m in metrics.items()))
        check(len(metrics) == 4 and all(math.isfinite(m["psnr"]) for m in metrics.values()),
              f"recon_test metrics: {metrics}")
        expect_launches(device, test_launches, expected, "recon_test")
        out["test"] = {"launches": test_launches, "seconds": test_s}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# Canonical space (TightCap): the body model, the deform and the canonical paths
# --------------------------------------------------------------------------


def orbit_camera(bounds: np.ndarray, S: int, theta: float = 0.7):
    """(K, R, T) of a camera on an orbit around the box ``bounds``, looking at
    its centre from 2.5 times its largest side, the box about 60 % of the
    image (scripts/canonical_jax_reference.py's camera)."""
    c = bounds.mean(0).astype(np.float64)
    e = float((bounds[1] - bounds[0]).max())
    d = 2.5 * e
    way = np.asarray([np.cos(theta), 0.15, np.sin(theta)])
    eye = c + d * way / np.linalg.norm(way)
    fwd = (c - eye) / np.linalg.norm(c - eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, -np.cross(right, fwd), fwd], axis=0)
    T = (-R @ eye).reshape(3, 1)
    f = 0.6 * S * d / e
    return np.asarray([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]]), R, T


class CanonicalScene:
    """The seeded SMPL-shaped synthetic body (J 24, V 6,890, 10 betas) in
    ``n_poses`` seeded poses, each placed in the world by a seeded rotation
    and a translation of 1 to 3 m, and TightCap items of it from 512^2
    images: each pose seen by ``n_views`` orbit cameras, its garment masks
    made by projecting the posed vertices, its colours seeded. Items come
    from data/tightcap.py::build_item, the array half of the loader."""

    def __init__(self, n_poses: int = 4, n_views: int = 8, S: int = 512, seed: int = 0):
        import torch

        from humanliff_tpu_torch.bodymodel.rotations import batch_rodrigues
        from humanliff_tpu_torch.bodymodel.smpl import lbs_forward_np, make_synthetic_body_model
        from humanliff_tpu_torch.data.tightcap import big_pose_bounds

        self.body = make_synthetic_body_model(J=24, V=6890, n_betas=10, seed=0)
        self.t_pose, _, self.box = big_pose_bounds(self.body)
        rng = np.random.default_rng(seed)
        self.S, self.n_views = S, n_views
        self.poses = []
        for _ in range(n_poses):
            poses = rng.normal(scale=0.2, size=72).astype(np.float32)
            betas = rng.normal(scale=0.5, size=10).astype(np.float32)
            axis = rng.normal(size=3)
            Rg = batch_rodrigues(torch.from_numpy(
                (axis / np.linalg.norm(axis) * rng.uniform(0.2, 1.0)).astype(np.float32))).numpy()
            way = rng.normal(size=3)
            Th = (way / np.linalg.norm(way) * rng.uniform(1.0, 3.0)).astype(np.float32)
            verts = lbs_forward_np(self.body, poses, betas) @ Rg.T + Th
            self.poses.append(dict(poses=poses, betas=betas, Rg=Rg, Th=Th, world=verts))
        self._views = {}

    def view(self, p: int, v: int) -> dict:
        """Camera, image and masks of pose ``p`` from orbit camera ``v``."""
        key = (p, v)
        if key not in self._views:
            pose, S = self.poses[p], self.S
            world = pose["world"]
            bounds = np.stack([world.min(0), world.max(0)])
            K, R, T = orbit_camera(bounds, S, theta=2 * np.pi * v / self.n_views)
            uvw = (world @ R.T + T.T) @ K.T
            px = np.round(uvw[:, :2] / uvw[:, 2:]).astype(int)
            hit = np.zeros((S, S), np.float32)
            ok = (px >= 0).all(1) & (px < S).all(1)
            hit[px[ok, 1], px[ok, 0]] = 1.0
            full = hit.copy()
            for dy in range(-4, 5):  # a 9 x 9 dilation: the splatted body
                for dx in range(-4, 5):
                    full = np.maximum(full, np.roll(np.roll(hit, dy, 0), dx, 1))
            rng = np.random.default_rng(1000 * p + v)
            img = np.kron(rng.uniform(0.2, 0.9, (S // 32, S // 32, 3)),
                          np.ones((32, 32, 1))).astype(np.float32)
            ys = np.flatnonzero(full.any(1))
            y0, y1 = ys.min(), ys.max() + 1

            def band(a, b):  # the body's rows from a to b of its height
                rows = np.arange(S)[:, None]
                return full * ((rows >= y0 + a * (y1 - y0)) & (rows < y0 + b * (y1 - y0)))

            garments = {"naked": full * (rng.uniform(size=(S, S)) < 0.9),
                        "top": band(0.0, 0.4), "bottom": band(0.4, 0.85),
                        "shoes": band(0.85, 1.01)}
            self._views[key] = dict(img=img, full_mask=full, garments=garments, K=K, R_cam=R,
                                    T_cam=T)
        return self._views[key]

    def item(self, instance: int, layer: int, p: int, v: int, n_rays: int, rng) -> dict:
        from humanliff_tpu_torch.data.tightcap import build_item

        pose = self.poses[p]
        return build_item(self.body, layer, **self.view(p, v), poses=pose["poses"],
                          betas=pose["betas"], Rg=pose["Rg"], Th=pose["Th"],
                          t_pose=self.t_pose, t_world_bounds=self.box, instance=instance,
                          n_rays=n_rays, rng=rng)

    def batch(self, device, rng, n_rays: int, num_instances: int, B: int = 2) -> dict:
        """B seeded items as a batch on ``device``."""
        from humanliff_tpu_torch.cli.recon_train import to_device

        its = [self.item(int(rng.integers(num_instances)), int(rng.integers(4)),
                         int(rng.integers(len(self.poses))), int(rng.integers(self.n_views)),
                         n_rays, rng) for _ in range(B)]
        return to_device({k: np.stack([it[k] for it in its]) for k in its[0]}, device)


def _canonical_deform_card_vs_cpu(device, scene, M: int = CANON_DEFORM_POINTS) -> dict:
    """Check 1: deform_to_canonical_batched at B 2, M points a item around
    the posed bodies (SMPL space), on the card and on the CPU; the 1-NN and
    the whole deform timed by CUDA events, and the deform's peak memory."""
    import torch

    from humanliff_tpu_torch.bodymodel.canonical import (
        deform_to_canonical_batched,
        nearest_vertex_batched,
    )
    from humanliff_tpu_torch.bodymodel.smpl import lbs_forward_np

    rng = np.random.default_rng(7)
    B = 2
    poses = np.stack([p["poses"] for p in scene.poses[:B]])
    betas = np.stack([p["betas"] for p in scene.poses[:B]])
    verts = np.stack([lbs_forward_np(scene.body, poses[b], betas[b]) for b in range(B)])
    near = verts[np.arange(B)[:, None], rng.integers(0, verts.shape[1], size=(B, M))]
    pts = (near + rng.normal(scale=0.1, size=(B, M, 3))).astype(np.float32)
    dirs = rng.normal(size=(B, M, 3)).astype(np.float32)
    big = np.stack([scene.t_pose] * B)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (poses, betas, big, verts, pts,
                                                                dirs)]
    t0 = time.perf_counter()
    cpu_ids = nearest_vertex_batched(args[4], args[3])
    cpu_pts, cpu_dirs = deform_to_canonical_batched(scene.body, *args)
    cpu_s = time.perf_counter() - t0
    dev_args = [a.to(device) for a in args]
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    ids = nearest_vertex_batched(dev_args[4], dev_args[3]).cpu()
    got_pts, got_dirs = (t.cpu() for t in deform_to_canonical_batched(scene.body, *dev_args))
    out = {"cpu_s": cpu_s}
    if device.type == "cuda":
        out["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        out["nn_ms"] = cuda_ms(lambda: nearest_vertex_batched(dev_args[4], dev_args[3]), 5)
        out["deform_ms"] = cuda_ms(lambda: deform_to_canonical_batched(scene.body, *dev_args), 5)
    agree = ids == cpu_ids
    out["id_agree"] = float(agree.double().mean())
    out["disagree_points"] = int((~agree).sum())
    a = agree[..., None].expand_as(got_pts)
    out["pts_err"] = float((got_pts - cpu_pts).abs()[a].max())
    out["dirs_err"] = float((got_dirs - cpu_dirs).abs()[a].max())
    say(f"[canonical] check 1, batched deform B {B} x M {M} (V 6,890), card vs CPU: "
        f"{json.dumps(out)} (bars: ids {CANON_ID_AGREE}, {CANON_DEFORM_ATOL} abs where they "
        f"agree); disagreeing share {1 - out['id_agree']:.3e}")
    check(out["id_agree"] >= CANON_ID_AGREE, f"deform ids agree on {out['id_agree']}")
    check(max(out["pts_err"], out["dirs_err"]) <= CANON_DEFORM_ATOL,
          f"deform card vs CPU: {out['pts_err']}, {out['dirs_err']}")
    return out


def _canonical_small_card_vs_cpu(device, scene) -> dict:
    """Check 2: one deterministic canonical step at D 32 (2 instances, 64
    rays, 16 + 16 samples, the fitted decoder), card vs CPU."""
    import torch

    from humanliff_tpu_torch.nerf.renderer import RenderConfig
    from humanliff_tpu_torch.train.stage1 import Stage1Config

    cfg = Stage1Config(num_instances=2, triplane_dim=32, use_canonical_space=True,
                       render=RenderConfig(n_samples=16, n_importance=16, perturb=False,
                                           density_noise=False))
    out = small_step_card_vs_cpu(
        device, cfg, torch.from_numpy(stage1_fixture_planes(2, 4, 32)),
        lambda dev: scene.batch(dev, np.random.default_rng(3), 64, 2), "canonical small",
        body_model=scene.body)
    say(f"[canonical] check 2, one canonical step at D 32 / 64 rays / 16 + 16 samples, card vs "
        f"CPU: {json.dumps(out)}")
    return out


class DeformTimer:
    """Wraps ``train.stage1.canonical_deform`` so that, while ``on``, each
    deform call is timed by CUDA events and kept with its inputs: ``ms()``
    sums the events (the deform's span on the stream, launch gaps
    included), ``kernel_ms()`` replays the kept calls under torch.profiler
    and sums their kernels' device time."""

    def __init__(self, real):
        self.real, self.on, self.events, self.calls = real, False, [], []

    def __call__(self, batch, body_model):
        import torch

        deform = self.real(batch, body_model)

        def timed(pts, dirs):
            if not self.on:
                return deform(pts, dirs)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = deform(pts, dirs)
            end.record()
            self.events.append((start, end))
            self.calls.append((deform, pts, dirs))
            return out
        return timed

    def ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events)

    def kernel_ms(self) -> float:
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for deform, pts, dirs in self.calls:
                deform(pts, dirs)
            torch.cuda.synchronize()
        return sum(device_us(e) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def _canonical_flagship(device, scene, steps: int, config=TIGHTCAP_CONFIG) -> dict:
    """Check 3: ``steps`` canonical training steps at the TightCap config's
    width (its instances, D, channels, rays, samples, TV, L1, clamp; fp32),
    on items built from the scene before the first step: s/step, device
    ms/step, busy share, the deform's share of the profiled step's kernel
    time, peak memory, and exactly 2 launches a step."""
    import statistics

    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.cli.recon_train import stage1_config
    from humanliff_tpu_torch.train import stage1
    from humanliff_tpu_torch.train.optim import make_stage1_optimizer
    from humanliff_tpu_torch.utils.config import parse_with_config, stage1_parser

    args = parse_with_config(stage1_parser(), ["--config", config])
    cfg = stage1_config(args)
    check(cfg.use_canonical_space, f"{config} is not a canonical-space config")
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    batches = [scene.batch(device, rng, args.n_rand, cfg.num_instances, args.batch_size)
               for _ in range(steps)]
    items_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = stage1.create_train_state(stage1.init_params(cfg, seed=0, device=device),
                                      make_stage1_optimizer(args.lrate, args.tri_plane_lrate,
                                                            args.lrate_decay))
    generator = torch.Generator(device=device).manual_seed(0)
    timer = StepTimer(stage1.train_step, device, profile_at=2)
    deform_timer = DeformTimer(stage1.canonical_deform)
    stage1.canonical_deform = deform_timer
    losses = []
    kernels.reset_launches()
    try:
        for i, batch in enumerate(batches):
            deform_timer.on = device.type == "cuda" and i == timer.profile_at
            losses.append(float(timer(state, batch, cfg, generator, scene.body)["loss"]))
    finally:
        stage1.canonical_deform = deform_timer.real
    launches = kernels.LAUNCHES["fused_decoder"]
    deform_kernel_ms = deform_timer.kernel_ms() if device.type == "cuda" else None
    rec = {"steps": steps, "items_s": items_s, "losses": losses, "launches": launches,
           "wall_s_all": timer.wall, "table_gb": state.params["planes"].numel() * 4 / 1e9,
           "wall_s_per_step": statistics.median(timer.wall[3:])}
    del state, batches
    check(all(math.isfinite(v) for v in losses), f"non-finite canonical losses: {losses}")
    if device.type == "cuda":
        rec.update(event_ms_per_step=statistics.median(timer.event_ms[3:]),
                   kernel_ms=timer.kernel_ms, kernels=timer.kernels,
                   busy=timer.kernel_ms / (1e3 * rec["wall_s_per_step"]),
                   deform_span_ms=deform_timer.ms(), deform_ms=deform_kernel_ms,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        rec["deform_share"] = rec["deform_ms"] / timer.kernel_ms
        say(f"[canonical] check 3, {config} width ({cfg.num_instances} instances, D "
            f"{cfg.triplane_dim}, {args.batch_size} x {args.n_rand} rays, "
            f"{cfg.render.n_samples} + {cfg.render.n_importance} samples, fp32): {steps} steps; "
            f"s/step (median of steps 4-{steps}) {rec['wall_s_per_step']:.4f}; device ms/step "
            f"{rec['event_ms_per_step']:.3f}; profiled step {timer.profile_at + 1}: "
            f"{timer.kernel_ms:.3f} ms of kernels ({timer.kernels} launches), busy share "
            f"{rec['busy']:.4f}; the deform's kernels {rec['deform_ms']:.3f} ms "
            f"({rec['deform_share']:.4f} of the kernel time; its span on the stream "
            f"{rec['deform_span_ms']:.3f} ms); peak memory {rec['peak_gb']:.3f} GB (table "
            f"{rec['table_gb']:.3f} GB); {steps} x {args.batch_size} items built in "
            f"{items_s:.3f} s")
        say("[canonical] profiled step, operators by kernel ms (ms, calls): "
            + "; ".join(f"{k} {ms:.3f} ({n})" for k, ms, n in timer.top))
    say(f"[canonical] losses: {', '.join(f'{v:.6f}' for v in losses)}; per-step wall s: "
        f"{', '.join(f'{w:.4f}' for w in timer.wall)}")
    expect_launches(device, launches, 2 * steps,
                    f"canonical train ({steps} steps: the coarse and the fine pass each)")
    return rec


def _canonical_descent_and_kernel(device, scene, steps: int = 10, D: int = 256,
                                  n_rays: int = 2048, samples: int = 128) -> dict:
    """Checks 4 and 5: ``steps`` deterministic canonical steps on one fixed
    batch (2 instances) must lower the loss by CANON_DESCENT_MIN_DROP; the
    first step's fine pass inputs (features at deformed points, deformed
    directions) go through the kernel and decoder_plain, within the kernel
    phase's fp32 bar."""
    import torch

    from humanliff_tpu_torch.nerf.renderer import RenderConfig
    from humanliff_tpu_torch.ops.fused_decoder import decoder_plain, fused_decoder
    from humanliff_tpu_torch.train import stage1
    from humanliff_tpu_torch.train.optim import make_stage1_optimizer

    cfg = stage1.Stage1Config(num_instances=2, triplane_dim=D, use_canonical_space=True,
                              render=RenderConfig(n_samples=samples, n_importance=samples,
                                                  perturb=False, density_noise=False))
    state = stage1.create_train_state(stage1.init_params(cfg, seed=0, device=device),
                                      make_stage1_optimizer())
    batch = scene.batch(device, np.random.default_rng(21), n_rays, 2)
    captured = []
    real = stage1.FlatDecoder

    class Capture(real):
        def __call__(self, feats, dirs=None):
            if dirs is not None and not captured:
                captured.append((feats.detach().clone(), dirs.detach().clone(),
                                 tuple(w.detach().clone() for w in self.weights())))
            return super().__call__(feats, dirs)

    stage1.FlatDecoder = Capture
    try:
        losses = [float(stage1.train_step(state, batch, cfg, body_model=scene.body)["loss"])
                  for _ in range(steps + 1)]
    finally:
        stage1.FlatDecoder = real
    drop = 1.0 - losses[-1] / losses[0]
    say(f"[canonical] check 4, descent on a fixed canonical batch (D {D}, {n_rays} rays x 2, "
        f"{samples} + {samples} samples): loss {losses[0]:.6f} -> {losses[-1]:.6f} after "
        f"{steps} steps ({drop:.4%}; bar {CANON_DESCENT_MIN_DROP:.2%}): "
        f"{', '.join(f'{v:.6f}' for v in losses)}")
    check(all(math.isfinite(v) for v in losses) and drop >= CANON_DESCENT_MIN_DROP,
          f"the canonical loss did not descend: {losses}")
    feats, dirs, w = captured[0]
    with torch.no_grad():
        rgb, alpha = fused_decoder(w, feats, dirs)
        ref_rgb, ref_alpha = decoder_plain(w, feats, dirs)
    sync(device)
    scale = max(float(ref_rgb.abs().max()), float(ref_alpha.abs().max()))
    err = max(float((rgb - ref_rgb).abs().max()), float((alpha - ref_alpha).abs().max()))
    tol = 1e-4 + 1e-5 * scale
    norms = dirs.norm(dim=-1)
    say(f"[canonical] check 5, the kernel vs decoder_plain on the first step's fine pass "
        f"({feats.shape[0]} points, deformed directions |d| {float(norms.min()):.3f}-"
        f"{float(norms.max()):.3f}): max abs err {err:.3e} (tol {tol:.3e}, max|ref| {scale:.3e})")
    check(err <= tol and bool(torch.isfinite(rgb).all()),
          f"the kernel on canonical inputs is {err} from decoder_plain (tol {tol})")
    return {"losses": losses, "drop": drop, "kernel_err": err, "kernel_points": feats.shape[0],
            "dir_norm_max": float(norms.max())}


def _canonical_eval_committed(device) -> dict:
    """Check 6: the committed fitted planes (campaign0000, layer 3, fp32) in
    the JAX reference's canonical scene through make_eval_deform_fn: the
    128^2 view by the exact tier against the JAX package's, by the fast tier
    against the card's exact tier, and extract_mesh at 128^3 of the posed
    subject (the lattice over the posed bounds, deformed); each path's
    launches against the count worked out from its chunking."""
    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.bodymodel.canonical import make_eval_deform_fn
    from humanliff_tpu_torch.bodymodel.smpl import make_synthetic_body_model
    from humanliff_tpu_torch.data.raygen import full_image_rays
    from humanliff_tpu_torch.nerf.fastpath import build_density_grid, render_image_fast
    from humanliff_tpu_torch.nerf.geometry import extract_mesh
    from humanliff_tpu_torch.nerf.renderer import RenderConfig, bind_deform, render_image_masked

    with np.load(CANONICAL_REFERENCE) as z:
        ref = {k: z[k] for k in z.files}
    body = make_synthetic_body_model(J=24, V=6890, n_betas=10, seed=0)
    check(float(body.v_template.astype(np.float64).sum()) == float(ref["v_template_sum"]),
          "the synthetic body model differs from the reference's")
    S, n = int(ref["image_size"]), int(ref["n_samples"])
    ro, rd, near, far, mask = full_image_rays(S, S, ref["K"], ref["R_cam"], ref["T_cam"],
                                              ref["world_bounds"])
    check(np.array_equal(mask, ref["mask"]), "the reference's in-box rays differ")
    deform = make_eval_deform_fn(body)
    args = {k: ref[k] for k in ("poses", "betas", "t_poses", "R", "Th", "smpl_verts")}
    box = ref["box_warp"]
    dec = load_fitted_decoder(device)
    planes = load_fitted_planes(int(ref["layer"])).to(device)
    cfg = RenderConfig(n_samples=n, n_importance=n, perturb=False, density_noise=False)
    n_rays = int(mask.sum())
    out, paths = {}, {}

    kernels.reset_launches()
    t0 = time.perf_counter()
    exact = render_image_masked(dec, planes, ro, rd, near, far, mask, box, cfg,
                                deform_fn=deform, deform_args=args)
    sync(device)
    out["exact_s"] = time.perf_counter() - t0
    paths["canonical exact view"] = kernels.LAUNCHES["fused_decoder"]
    expect_launches(device, paths["canonical exact view"], 2 * math.ceil(n_rays / RENDER_CHUNK),
                    "canonical exact view")
    rgb = exact["rgb"].float().cpu().numpy()
    out["exact_vs_jax_db"] = psnr_db(rgb[mask], ref["rgb"][mask])
    out["acc_vs_jax_db"] = psnr_db(exact["acc"].cpu().numpy()[mask], ref["acc"][mask])

    kernels.reset_launches()
    t0 = time.perf_counter()
    grid = build_density_grid(dec, planes, box, resolution=int(ref["grid_resolution"]),
                              build_chunk=GRID_CHUNK)
    sync(device)
    out["grid_s"] = time.perf_counter() - t0
    paths["canonical grid build"] = kernels.LAUNCHES["fused_decoder"]
    eps = float(ref["early_term_eps"])
    kernels.reset_launches()
    t0 = time.perf_counter()
    fast = render_image_fast(dec, planes, grid, ro, rd, near, far, mask, box, cfg,
                             chunk=RENDER_CHUNK, early_term_eps=eps, deform_fn=deform,
                             deform_args=args)
    sync(device)
    out["fast_s"] = time.perf_counter() - t0
    paths["canonical fast view"] = kernels.LAUNCHES["fused_decoder"]
    rays = [torch.from_numpy(a[mask]).to(device) for a in (ro, rd, near, far)]
    kept = int(kept_rays(grid, rays, torch.from_numpy(box).to(device), cfg, eps,
                         bind_deform(deform, args)).sum())
    R = int(ref["grid_resolution"])
    expect_launches(device, paths["canonical grid build"], math.ceil((R + 1) ** 3 / GRID_CHUNK),
                    "canonical grid build")
    expect_launches(device, paths["canonical fast view"], math.ceil(kept / RENDER_CHUNK),
                    f"canonical fast view ({kept} of {n_rays} rays kept)")
    out["fast_vs_exact_db"] = psnr_db(fast["rgb"].cpu().numpy()[mask], rgb[mask])
    fast_bar = float(ref["fast_vs_exact_db"]) - CANON_FAST_MARGIN_DB

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = 128
    verts, tris = extract_mesh(dec, planes, ref["world_bounds"], resolution=res,
                               deform_fn=bind_deform(deform, args))
    out["mesh_s"] = time.perf_counter() - t0
    paths["canonical mesh"] = kernels.LAUNCHES["fused_decoder"]
    expect_launches(device, paths["canonical mesh"], math.ceil(res ** 3 / MESH_CHUNK),
                    f"canonical mesh ({res}^3)")
    out.update(kept=kept, n_rays=n_rays, verts=len(verts), tris=len(tris),
               jax_fast_vs_exact_db=float(ref["fast_vs_exact_db"]), paths=paths)
    say(f"[canonical] check 6, the committed planes through the eval deform, {S}^2 view: exact "
        f"{out['exact_s']:.3f} s, vs JAX {out['exact_vs_jax_db']:.4f} dB rgb, "
        f"{out['acc_vs_jax_db']:.4f} dB acc (bar {CANON_EXACT_DB} dB); grid {out['grid_s']:.3f} s"
        f" + fast {out['fast_s']:.3f} s, {kept} of {n_rays} rays kept, fast vs exact "
        f"{out['fast_vs_exact_db']:.4f} dB (JAX's own {out['jax_fast_vs_exact_db']:.4f} dB; "
        f"bar {fast_bar:.4f} dB); mesh {res}^3 of the posed subject {out['mesh_s']:.3f} s, "
        f"{len(verts)} verts, {len(tris)} tris")
    check(np.isfinite(rgb).all(), "non-finite canonical render")
    check(out["exact_vs_jax_db"] >= CANON_EXACT_DB,
          f"canonical exact tier is {out['exact_vs_jax_db']:.2f} dB from JAX's")
    check(out["fast_vs_exact_db"] >= fast_bar,
          f"canonical fast tier is {out['fast_vs_exact_db']:.2f} dB from the exact tier")
    wb = ref["world_bounds"]
    check(len(tris) > 0 and np.isfinite(verts).all() and (verts >= wb[0] - 1e-4).all()
          and (verts <= wb[1] + 1e-4).all(), "empty, non-finite or out-of-box canonical mesh")
    return out


def phase_canonical(device, steps: int = 20, descent=None, deform_points=CANON_DEFORM_POINTS,
                    config=TIGHTCAP_CONFIG, scene_kw=None) -> dict:
    """Canonical space's six checks (module docstring). ``descent`` goes to
    _canonical_descent_and_kernel, ``deform_points`` to check 1, ``config``
    (a CPU rehearsal's narrower copy of the TightCap config) to check 3,
    ``scene_kw`` to CanonicalScene."""
    scene = CanonicalScene(**(scene_kw or {}))
    out = {"deform": _canonical_deform_card_vs_cpu(device, scene, deform_points),
           "small": _canonical_small_card_vs_cpu(device, scene),
           "flagship": _canonical_flagship(device, scene, steps, config)}
    out["descent"] = _canonical_descent_and_kernel(device, scene, **(descent or {}))
    out["eval"] = _canonical_eval_committed(device)
    return out


# --------------------------------------------------------------------------
# The quality campaigns: recon_refit, quality_eval, LPIPS, quality_stage2,
# the chain costs, bench_decode
# --------------------------------------------------------------------------


class PathLedger:
    """Wraps entry points (a module attribute each) so that the fused
    decoder's launches made inside a call, the count the call's own
    arguments give (``expect``) and its seconds (host clock between
    synchronizes) add to a named path. ``capture(args, kwargs, out)`` sees
    each call. Used as a context manager: the wrapped attributes are
    restored on exit."""

    def __init__(self, device):
        self.device = device
        self.launches, self.expected, self.seconds, self.calls = {}, {}, {}, {}
        self._undo = []

    def wrap(self, module, name: str, key: str, expect=None, capture=None) -> None:
        import inspect

        from humanliff_tpu_torch import kernels

        real = getattr(module, name)
        sig = inspect.signature(real)

        def wrapped(*args, **kwargs):
            if expect is not None:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                self.expected[key] = self.expected.get(key, 0) + expect(bound.arguments)
            sync(self.device)
            before = kernels.LAUNCHES["fused_decoder"]
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            sync(self.device)
            self.seconds[key] = self.seconds.get(key, 0.0) + time.perf_counter() - t0
            self.launches[key] = (self.launches.get(key, 0)
                                  + kernels.LAUNCHES["fused_decoder"] - before)
            self.calls[key] = self.calls.get(key, 0) + 1
            if capture is not None:
                capture(args, kwargs, out)
            return out

        setattr(module, name, wrapped)
        self._undo.append((module, name, real))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for module, name, real in reversed(self._undo):
            setattr(module, name, real)
        self._undo.clear()
        return False

    def check(self, key: str, what: str) -> int:
        expect_launches(self.device, self.launches.get(key, 0), self.expected.get(key, 0),
                        f"{what} ({self.calls.get(key, 0)} calls)")
        return self.launches.get(key, 0)


def exact_render_launches(a) -> int:
    """render_image_masked's launches: coarse + fine per chunk of in-box rays."""
    return 2 * math.ceil(int(np.asarray(a["mask"]).sum()) / a["chunk"])


def grid_build_launches(a) -> int:
    return math.ceil((a["resolution"] + 1) ** 3 / a["build_chunk"])


def fast_render_launches(a) -> int:
    """render_image_fast's launches: one per ``chunk`` kept rays of each group
    of ``max_rays_in_flight``, the kept rays worked out from the same grid
    and the same coarse phase (no decoder call)."""
    import torch

    check(a["deform_fn"] is None, "fast_render_launches counts world-space renders only")
    mask = np.asarray(a["mask"]).reshape(-1).astype(bool)
    device = a["planes"].device
    rays = [torch.as_tensor(np.asarray(r, np.float32)).reshape(mask.size, -1).squeeze(-1)
            [torch.from_numpy(mask)].to(device)
            for r in (a["rays_o"], a["rays_d"], a["near"], a["far"])]
    box = torch.as_tensor(np.asarray(a["box_warp"], np.float32)).to(device)
    cfg = dataclasses.replace(a["cfg"], perturb=False, density_noise=False)
    keep = kept_rays(a["grid"], rays, box, cfg, a["early_term_eps"]).cpu()
    chunk = a["chunk"]
    group = max(chunk, (a["max_rays_in_flight"] // chunk) * chunk)
    return sum(math.ceil(int(keep[g:g + group].sum()) / chunk)
               for g in range(0, keep.shape[0], group))


def _copy_campaign_pair(out: str) -> None:
    """The committed fitted pair in quality_stage2's layout under ``out``."""
    planes_dir = os.path.join(out, "stage2", "planes")
    os.makedirs(planes_dir)
    os.makedirs(os.path.join(out, "train"))
    for path in (PLANES_NPZ, PLANES_NPZ_1):
        shutil.copy(path, os.path.join(planes_dir, os.path.basename(path)))
    shutil.copy(DECODER_NPZ, os.path.join(out, "train", os.path.basename(DECODER_NPZ)))


def _quality_refit(device, out: str, tmp: str, campaign, steps: int) -> dict:
    """Checks 1 and 2: recon_refit's reassembly (0 steps) into ``out``/train,
    then a 20-step refit at the campaign width into its own directory."""
    import statistics

    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.cli import recon_refit
    from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
    from humanliff_tpu_torch.nerf.decoder import flatten_state_dict
    from humanliff_tpu_torch.train import checkpoint as ckpt
    from humanliff_tpu_torch.train.stage1 import train_step

    exports = [os.path.join(out, "stage2", "planes", os.path.basename(p))
               for p in (PLANES_NPZ, PLANES_NPZ_1)]
    sidecar = os.path.join(out, "train", os.path.basename(DECODER_NPZ))
    want_planes = [torch.from_numpy(ckpt.load_subject_planes(p)) for p in exports]
    want_dec = flatten_state_dict(decoder_state_dict(ckpt.load_decoder_npz(DECODER_NPZ)))
    refit = campaign + ["--plane_files", os.path.join(out, "stage2", "planes", "campaign*.npz"),
                        "--decoder_from", sidecar, "--expname", "train"]

    def saved(expdir):
        restored, step = ckpt.restore_state(expdir)
        planes_same = all(torch.equal(restored["planes"][i], want_planes[i]) for i in range(2))
        return restored, step, planes_same

    # Check 1: reassembly.
    argv = refit + ["--refit_steps", "0", "--basedir", out]
    say(f"[quality] python -m humanliff_tpu_torch.cli.recon_refit {' '.join(argv)}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    recon_refit.main(argv)
    reassembly_s = time.perf_counter() - t0
    restored, step, planes_same = saved(os.path.join(out, "train"))
    dec_same = torch.equal(restored["decoder"], want_dec)
    stamp = os.path.exists(os.path.join(out, "train", f"{step:06d}_REFIT.txt"))
    say(f"[quality] check 1, recon_refit --refit_steps 0 in {reassembly_s:.3f} s: step {step}, "
        f"planes bit for bit {planes_same}, decoder bit for bit the sidecar {dec_same}, "
        f"{step:06d}_REFIT.txt {stamp}; launches {kernels.LAUNCHES['fused_decoder']}")
    check(step == 60000 and planes_same and dec_same and stamp,
          "recon_refit's reassembly did not keep the exports and the sidecar")
    check(kernels.LAUNCHES["fused_decoder"] == 0, "the reassembly launched the decoder")
    del restored

    # Check 2: 20 refit steps.
    refit_dir = os.path.join(tmp, "refit")
    argv = refit + ["--refit_steps", str(steps), "--i_print", str(max(steps // 2, 1)),
                    "--basedir", refit_dir]
    say(f"[quality] python -m humanliff_tpu_torch.cli.recon_refit {' '.join(argv)}")
    timer = StepTimer(train_step, device, profile_at=2)
    kernels.reset_launches()
    recon_refit.train_step = timer
    try:
        t0 = time.perf_counter()
        recon_refit.main(argv)
        refit_s = time.perf_counter() - t0
    finally:
        recon_refit.train_step = train_step
    launches = kernels.LAUNCHES["fused_decoder"]
    restored, step, planes_same = saved(os.path.join(refit_dir, "train"))
    moved = float((restored["decoder"] - want_dec).abs().max())
    with open(os.path.join(refit_dir, "train", "progress.json")) as f:
        logs = [json.loads(line) for line in f]
    wall_s = statistics.median(timer.wall[3:]) if len(timer.wall) > 3 else timer.wall[-1]
    rec = {"steps": steps, "refit_s": refit_s, "reassembly_s": reassembly_s,
           "wall_s_per_step": wall_s, "wall_s_all": timer.wall, "launches": launches,
           "decoder_moved": moved, "losses": [m["loss"] for m in logs]}
    if device.type == "cuda":
        rec.update(event_ms_per_step=statistics.median(timer.event_ms[3:]),
                   kernel_ms=timer.kernel_ms, busy=timer.kernel_ms / (1e3 * wall_s))
        say(f"[quality] check 2, recon_refit {steps} steps in {refit_s:.3f} s: s/step (median "
            f"of steps 4-{steps}) {wall_s:.4f}; device ms/step by CUDA events "
            f"{rec['event_ms_per_step']:.3f}; profiled step {timer.profile_at + 1}: "
            f"{timer.kernel_ms:.3f} ms of kernels, busy share {rec['busy']:.4f}")
    say(f"[quality] check 2: losses {rec['losses']}; planes bit for bit {planes_same}; "
        f"decoder moved by {moved:.3e} max abs; step {step}; per-step wall s "
        f"{', '.join(f'{w:.4f}' for w in timer.wall)}")
    check(planes_same, "the refit moved the frozen planes")
    check(moved > 0.0, "the refit did not move the decoder")
    check(step == 60000 and all(math.isfinite(v) for v in rec["losses"]),
          f"refit step {step}, losses {rec['losses']}")
    expect_launches(device, launches, 2 * steps, f"refit ({steps} steps: coarse + fine each)")
    shutil.rmtree(refit_dir, ignore_errors=True)
    return rec


def _quality_eval(device, out: str, eval_flags=()) -> dict:
    """Check 3: quality_eval --skip_train --fast_eval on the reassembled
    state, each exact view against the JAX package's PSNR."""
    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.cli import quality_eval
    from humanliff_tpu_torch.eval import harness
    from humanliff_tpu_torch.eval.metrics import lpips_fn
    from humanliff_tpu_torch.nerf import fastpath

    with open(STAGE1_REFERENCE) as f:
        ref = json.load(f)
    renders = []

    def keep_render(args, kwargs, out_):
        if len(renders) < 2:
            renders.append(out_["rgb"].float().cpu().numpy())

    argv = ["--out_dir", out, "--skip_train", "--fast_eval", "--device", device.type,
            *eval_flags]
    say(f"[quality] python -m humanliff_tpu_torch.cli.quality_eval {' '.join(argv)}")
    kernels.reset_launches()
    with PathLedger(device) as led:
        led.wrap(harness, "render_image_masked", "exact", exact_render_launches, keep_render)
        led.wrap(fastpath, "build_density_grid", "fast", grid_build_launches)
        led.wrap(harness, "render_image_fast", "fast", fast_render_launches)
        t0 = time.perf_counter()
        results = quality_eval.main(argv)
        eval_s = time.perf_counter() - t0
    total = kernels.LAUNCHES["fused_decoder"]
    gaps, per_view = {}, {}
    for name in sorted(glob.glob(os.path.join(out, "eval_060000", "metrics_s*_l*.json"))):
        tag = os.path.basename(name)[len("metrics_"):-len(".json")]
        subject, layer = int(tag[1:5]), int(tag.split("_l")[1])
        with open(name) as f:
            rows = json.load(f)["per_view"]
        for view, row in zip((145 + 5 * layer, 165 + 5 * layer), rows):
            key = f"s{subject}_l{layer}_v{view}"
            per_view[key] = row
            if key in ref["eval"]:
                gaps[key] = row["psnr"] - ref["eval"][key]["psnr"]
    worst = max(gaps, key=lambda k: abs(gaps[k])) if gaps else None
    say(f"[quality] check 3, quality_eval ({len(per_view)} exact views + as many fast, "
        f"{ref['image_size']}^2) in {eval_s:.3f} s (exact {led.seconds.get('exact', 0):.3f} s, "
        f"fast {led.seconds.get('fast', 0):.3f} s): PSNR card - JAX CPU per view (bar "
        f"{QUALITY_EVAL_PSNR_DB} dB) "
        + ", ".join(f"{k} {ref['eval'][k]['psnr']:.4f}{gaps[k]:+.5f}" for k in sorted(gaps)))
    for k in sorted(results):
        say(f"[quality] check 3, {k}: {json.dumps(results[k])}")
    check(gaps and abs(gaps[worst]) <= QUALITY_EVAL_PSNR_DB,
          f"quality_eval: {worst} is {gaps.get(worst)} dB from the JAX CPU reference")
    check(os.path.exists(os.path.join(out, "QUALITY.md"))
          and os.path.exists(os.path.join(out, "quality_metrics.json")),
          "quality_eval wrote no QUALITY.md / quality_metrics.json")
    no_lpips = lpips_fn(device) is None and not any("lpips" in r for r in per_view.values())
    say(f"[quality] check 3: LPIPS column absent (no weights) {no_lpips}")
    check(no_lpips, "an LPIPS column without LPIPS weights")
    paths = {"quality_eval exact": led.check("exact", "quality_eval exact"),
             "quality_eval fast": led.check("fast", "quality_eval fast (grids + views)")}
    check(total == sum(paths.values()), f"quality_eval launched {total} times outside its renders")
    return {"eval_s": eval_s, "seconds": dict(led.seconds), "paths": paths, "gaps": gaps,
            "max_abs_gap_db": abs(gaps[worst]), "renders": renders,
            "size": ref["image_size"]}


def _lpips_card_vs_cpu(device, renders, size: int, reps: int = 10) -> dict:
    """Check 4: the full VGG16 LPIPS with seeded random weights on two
    renders of check 3, the card against the CPU (fp32, TF32 off)."""
    import torch

    from humanliff_tpu_torch.eval.lpips import LPIPS, VGG16_CFG, VGG16_SLICES

    rng = np.random.default_rng(0)
    params, cin, ci, chans = {}, 3, 0, []
    for c in VGG16_CFG:
        if c == "M":
            continue
        params[f"conv{ci}_w"] = rng.normal(0, np.sqrt(2.0 / (9 * cin)),
                                           (3, 3, cin, c)).astype(np.float32)
        params[f"conv{ci}_b"] = rng.normal(0, 0.01, (c,)).astype(np.float32)
        chans.append(c)
        cin, ci = c, ci + 1
    for li, sl in enumerate(VGG16_SLICES):
        params[f"lin{li}"] = rng.uniform(0, 1, (chans[sl - 1],)).astype(np.float32)
    a, b = (torch.from_numpy(r.reshape(size, size, 3)).permute(2, 0, 1)[None] * 2 - 1
            for r in renders)
    net_cpu = LPIPS().load_npz_params(params).eval()
    net = LPIPS().load_npz_params(params).to(device).eval()
    with torch.no_grad():
        d_cpu = float(net_cpu(a, b)[0])
        ad, bd = a.to(device), b.to(device)
        d_card = float(net(ad, bd)[0])
        ms = cuda_ms(lambda: net(ad, bd), reps) if device.type == "cuda" else None
    rel = abs(d_card - d_cpu) / abs(d_cpu)
    say(f"[quality] check 4, LPIPS (VGG16, seeded weights) of two {size}^2 renders: card "
        f"{d_card!r}, CPU {d_cpu!r}, {rel:.3e} relative (rtol {LPIPS_RTOL}); "
        + (f"{ms:.3f} ms per pair (CUDA events, mean of {reps})" if ms is not None else ""))
    check(rel <= LPIPS_RTOL and d_cpu > 0, f"LPIPS card vs CPU: {d_card} vs {d_cpu}")
    return {"card": d_card, "cpu": d_cpu, "rel": rel, "ms": ms}


def _quality_stage2(device, out: str, stage2_flags) -> dict:
    """Check 5: quality_stage2 on ``out`` at the flagship UNet width, reduced
    depth: every leg's seconds, the fine-tune's and the decode's launches, a
    success report with the JAX key set and finite scores, and one decode
    view against a CPU re-render of 256 of its rays."""
    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.cli import diff_train, quality_stage2, recon_ft
    from humanliff_tpu_torch.eval import fidelity
    from humanliff_tpu_torch.nerf.renderer import render_rays
    from humanliff_tpu_torch.sampling import layered

    ft_steps = int(stage2_flags[stage2_flags.index("--ft_steps") + 1])
    ft_subjects = int(stage2_flags[stage2_flags.index("--ft_subjects") + 1])
    first = {}

    def keep_first(args, kwargs, out_):
        if not first:
            a = dict(zip(("decoder", "planes", "rays_o", "rays_d", "near", "far", "mask",
                          "box_warp", "cfg"), args))
            first.update(a, out={k: v.clone() for k, v in out_.items()})

    argv = ["--out_dir", out, "--device", device.type, *stage2_flags]
    say(f"[quality] python -m humanliff_tpu_torch.cli.quality_stage2 {' '.join(argv)}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with PathLedger(device) as led:
        led.wrap(recon_ft, "main", "ft", lambda a: 2 * 4 * ft_steps)
        led.wrap(diff_train, "main", "train")
        led.wrap(layered, "generate_workload", "sample")
        led.wrap(fidelity, "heldout_denoise_loss", "denoise loss")
        led.wrap(quality_stage2, "render_image_masked", "decode", exact_render_launches,
                 keep_first)
        t0 = time.perf_counter()
        metrics = quality_stage2.main(argv)
        stage2_s = time.perf_counter() - t0
    total = kernels.LAUNCHES["fused_decoder"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None
    work = os.path.join(out, "stage2")
    report = open(os.path.join(work, "STAGE2.md")).read()
    with open(os.path.join(work, "stage2_metrics.json")) as f:
        saved = json.load(f)
    say(f"[quality] check 5, quality_stage2 in {stage2_s:.3f} s, legs (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in led.seconds.items())
        + (f"; peak memory {peak_gb:.3f} GB" if peak_gb is not None else ""))
    for k in ("weights", "denoise_loss_heldout", "denoise_loss_train", "nearest_gt_psnr",
              "decoded_fidelity"):
        say(f"[quality] check 5, {k}: {json.dumps(saved[k])}")
    check("STATUS: FAILED" not in report and "Chain fidelity" in report,
          "quality_stage2 wrote no success report")
    check(set(saved) == set(STAGE2_JAX_KEYS),
          f"stage2_metrics.json keys {sorted(set(saved) ^ set(STAGE2_JAX_KEYS))} differ from JAX's")
    for split in ("denoise_loss_heldout", "denoise_loss_train"):
        check(sorted(int(k) for k in saved[split]) == [0, 1, 2, 3]
              and all(math.isfinite(v) for v in saved[split].values()),
              f"{split}: {saved[split]}")
    check(all(math.isfinite(v) for v in saved["nearest_gt_psnr"].values()),
          f"nearest-GT PSNR {saved['nearest_gt_psnr']}")
    check(len(saved["decoded_fidelity"]) == 3 and all(
        0.0 <= m["changed_pixel_fraction"] <= 1.0 and 0.0 <= m["occupancy_persistence"] <= 1.0
        and math.isfinite(m["unchanged_psnr"]) for m in saved["decoded_fidelity"].values()),
        f"decoded fidelity {saved['decoded_fidelity']}")
    check(metrics is not None and metrics["diff_step"] == saved["diff_step"],
          "quality_stage2 returned no metrics")

    # The first decode view (layer 0's sample 0) on the CPU, 256 of its rays.
    mask = np.asarray(first["mask"]).reshape(-1).astype(bool)
    idx = check_rays(mask, 256)
    with torch.no_grad():
        ref = render_rays(cpu_decoder(first["decoder"]), first["planes"].cpu(),
                          *(torch.from_numpy(np.asarray(first[k], np.float32)[idx])
                            for k in ("rays_o", "rays_d", "near", "far")),
                          torch.from_numpy(np.asarray(first["box_warp"], np.float32)),
                          dataclasses.replace(first["cfg"], perturb=False, density_noise=False))
    psnrs = compare_subset(first["out"], ref, idx, "quality_stage2 decode view, layer 0")
    ft = led.check("ft", f"quality_stage2 ft ({ft_subjects} subject, {ft_steps} steps x 4 "
                         "layers)")
    decode = led.check("decode", "quality_stage2 decode (4 layers)")
    check(total == ft + decode, f"quality_stage2 launched {total} times, {ft} + {decode} in "
                                "the fine-tune and the decode")
    return {"stage2_s": stage2_s, "seconds": dict(led.seconds), "peak_gb": peak_gb,
            "paths": {"quality_stage2 ft": ft, "quality_stage2 decode": decode},
            "psnr_cpu": psnrs, "metrics": saved}


def _chain_costs(device, model_kwargs=None, image_size=256, steps: int = 4,
                 repeats: int = 3) -> dict:
    """Check 6: seconds of a 4-layer x 250-step chain at B 1 and B 8, from
    ``steps`` respaced flagship UNet steps timed by CUDA events (median of
    ``repeats``) times 1,000 / ``steps``, and the plan for 25 samples."""
    import statistics

    import torch

    from humanliff_tpu_torch.models.factory import create_model_and_diffusion
    from humanliff_tpu_torch.sampling.layered import (
        DEFAULT_CHAIN_COSTS,
        generate_layer,
        plan_workload,
    )

    kw = dict(model_kwargs or {}, timestep_respacing=str(steps))
    with torch.device(device):
        model, diffusion = create_model_and_diffusion(image_size=image_size, **kw)
    seed_weights(model, 0)
    model.eval()
    if device.type == "cuda":
        model.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    gen = torch.Generator(device=device).manual_seed(0)
    channels = kw.get("in_channels", 27)
    costs = {}
    for B in (1, 8):
        def run():
            return generate_layer(model, diffusion, 1, None, gen, batch_size=B,
                                  image_size=image_size, channels=channels, device=device)

        run()  # warm-up
        times = []
        for _ in range(repeats):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                run()
                times.append(time.perf_counter() - t0)
        costs[B] = statistics.median(times) / steps * 1000
        say(f"[quality] check 6, B {B}: {steps} UNet steps in "
            + ", ".join(f"{t:.4f}" for t in times) + f" s; chain of 4 x 250 steps "
            f"{costs[B]:.3f} s")
    del model
    plan = plan_workload(25, costs)
    say(f"[quality] check 6, DEFAULT_CHAIN_COSTS must hold {json.dumps(costs)} (the port "
        f"holds {json.dumps(DEFAULT_CHAIN_COSTS)}); the plan for 25 samples: {plan} "
        f"({sum(costs[b] for b in plan):.3f} s; all B 1 {25 * costs[1]:.3f} s, all B 8 "
        f"{math.ceil(25 / 8) * costs[8]:.3f} s); the port's table plans "
        f"{plan_workload(25)}")
    check(all(math.isfinite(c) and c > 0 for c in costs.values()), f"chain costs {costs}")
    return {"costs": costs, "plan_25": plan, "port_plan_25": plan_workload(25)}


def _bench_decode(device, out: str, tmp: str, bench_flags=()) -> dict:
    """Check 7: bench_decode on the reassembled state, 512^2, layer 3."""
    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.cli import bench_decode
    from humanliff_tpu_torch.nerf import fastpath

    out_json = os.path.join(tmp, "bench_decode.json")
    argv = ["--ckpt_dir", os.path.join(out, "train"), "--out_json", out_json, "--num_views",
            "2", "--render_size", "512", "--layer", "3", "--device", device.type, *bench_flags]
    say(f"[quality] python -m humanliff_tpu_torch.cli.bench_decode {' '.join(argv)}")
    kernels.reset_launches()
    with PathLedger(device) as led:
        led.wrap(bench_decode, "render_image_masked", "exact", exact_render_launches)
        led.wrap(fastpath, "build_density_grid", "fast", grid_build_launches)
        led.wrap(bench_decode, "build_density_grid", "fast", grid_build_launches)
        led.wrap(bench_decode, "render_image_fast", "fast", fast_render_launches)
        t0 = time.perf_counter()
        bench_decode.main(argv)
        bench_s = time.perf_counter() - t0
    total = kernels.LAUNCHES["fused_decoder"]
    with open(out_json) as f:
        result = json.load(f)
    say(f"[quality] check 7, bench_decode in {bench_s:.3f} s: exact "
        f"{result['exact_s_per_view']:.4f} s/view (median {result['exact_s_per_view_median']:.4f}),"
        f" fast {result['fast_s_per_view']:.4f} s/view (median "
        f"{result['fast_s_per_view_median']:.4f}), speedup {result['speedup']:.3f}, grid build "
        f"{result['grid_build_s']:.4f} s; fast vs exact {result['fast_vs_exact_psnr_db']:.4f} dB "
        f"(bar {FITTED_FAST_VS_EXACT_DB:.4f} dB)")
    check(set(result) == set(BENCH_DECODE_JAX_KEYS),
          f"bench_decode keys {sorted(set(result) ^ set(BENCH_DECODE_JAX_KEYS))} differ from JAX's")
    check(result["fast_vs_exact_psnr_db"] >= FITTED_FAST_VS_EXACT_DB,
          f"bench_decode: fast tier {result['fast_vs_exact_psnr_db']} dB from the exact tier")
    paths = {"bench_decode exact": led.check("exact", "bench_decode exact"),
             "bench_decode fast": led.check("fast", "bench_decode fast (grids + views)")}
    check(total == sum(paths.values()), f"bench_decode launched {total} times outside its renders")
    return {"bench_s": bench_s, "result": result, "paths": paths}


def phase_quality(device, refit_steps: int = 20, campaign_flags=(), eval_flags=(),
                  stage2_flags=None, bench_flags=(), chain_kw=None) -> dict:
    """The quality campaigns' seven checks (module docstring), in a temporary
    directory holding the committed fitted pair in quality_stage2's layout.
    The keyword arguments narrow a CPU rehearsal: ``campaign_flags`` go to
    recon_refit, ``eval_flags`` to quality_eval, ``stage2_flags`` replace
    quality_stage2's, ``bench_flags`` go to bench_decode and ``chain_kw`` to
    _chain_costs."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_quality_")
    try:
        out = os.path.join(tmp, "campaign")
        _copy_campaign_pair(out)
        campaign = ["--data_set_type", "synthetic", "--num_instance", "2",
                    "--synthetic_image_size", "128", "--synthetic_tight_bounds", "true",
                    "--n_rand", "2048", "--batch_size", "2", "--n_samples", "128",
                    "--n_importance", "128", "--triplane_dim", "256", "--triplane_ch", "27",
                    "--device", device.type, *campaign_flags]
        rec = {"refit": _quality_refit(device, out, tmp, campaign, refit_steps)}
        rec["eval"] = _quality_eval(device, out, eval_flags)
        rec["lpips"] = _lpips_card_vs_cpu(device, rec["eval"].pop("renders"),
                                          rec["eval"]["size"])
        rec["stage2"] = _quality_stage2(device, out, list(stage2_flags or STAGE2_FLAGS))
        rec["chain"] = _chain_costs(device, **(chain_kw or {}))
        rec["bench"] = _bench_decode(device, out, tmp, bench_flags)
        rec["paths"] = {"refit": rec["refit"]["launches"], **rec["eval"]["paths"],
                        **rec["stage2"]["paths"], **rec["bench"]["paths"]}
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=250,
                    help="respaced DDPM steps per layer (of 1000)")
    ap.add_argument("--cli_steps", default="ddim50",
                    help="the CLI phase's --timestep_respacing")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    from humanliff_tpu_torch import kernels  # fails outside a checkout of the repo

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # Full-fp32 matmuls and convolutions outside autocast: the plain decoder is
    # the kernel's yardstick and the fp32 UNet forward the bf16 one's.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    cuda_sync = torch.cuda.synchronize
    t_start = time.perf_counter()
    summary = []

    with Phase("build", cuda_sync):
        build = phase_build()
        summary.append(f"build {build['seconds']:.3f} s")
    with Phase("kernel", cuda_sync):
        kern = phase_kernel(device)

    # The main path, path by path; each reads fused_decoder's launches from 0.
    paths = {}
    kernels.reset_launches()
    with Phase("generate", cuda_sync):
        gen = phase_generate(device, args.steps)
    summary.append(f"generation {sum(gen['per_layer_s']):.3f} s ({gen['steps']} steps x "
                   f"4 layers; per layer {', '.join(f'{s:.3f}' for s in gen['per_layer_s'])}"
                   " s)")
    with Phase("decode", cuda_sync):
        dec = phase_decode(device, gen["layers"]["person_pant_shirt_shoes"])
        expect_launches(device, dec["launches"],
                        2 * math.ceil(dec["n_rays"] / RENDER_CHUNK),
                        "generation + exact view (generated): coarse + fine per "
                        f"{RENDER_CHUNK}-ray chunk")
        paths["generate + exact view (generated)"] = dec["launches"]
        fast = phase_fast(device, dec["planes"], dec["ray_args"], "generated",
                          exact_rgb=dec["rgb"])
        paths["grid build (generated)"] = fast["grid_launches"]
        paths["fast view (generated)"] = fast["fast_launches"]
        fitted = phase_fitted_planes(device, dec["ray_args"])
        paths["exact view (fitted)"] = fitted["launches"]
        fast_fit = phase_fast(device, fitted["planes"], dec["ray_args"], "fitted",
                              exact_rgb=fitted["rgb"], exact_bar=FITTED_FAST_VS_EXACT_DB)
        paths["grid build (fitted)"] = fast_fit["grid_launches"]
        paths["fast view (fitted)"] = fast_fit["fast_launches"]
    summary.append(f"512^2 view 0, exact / fast (grid + render): generated "
                   f"{dec['render_s']:.3f} / {fast['render_s']:.3f} s, fitted "
                   f"{fitted['render_s']:.3f} / {fast_fit['render_s']:.3f} s")
    with Phase("mesh", cuda_sync):
        mesh = phase_mesh(device)
        paths[f"mesh {MESH_RESOLUTION}^3 (fitted)"] = mesh["launches"]
    summary.append(f"mesh {MESH_RESOLUTION}^3 {mesh['mesh_s']:.3f} s")
    with Phase("cli", cuda_sync):
        cli = phase_cli(device, gen["layers"]["person_pant_shirt"], args.cli_steps,
                        cli_flags=("--mesh_resolution", str(CLI_MESH_RESOLUTION)))
        paths["cli"] = cli["launches"]
    summary.append(f"cli {cli['cli_s']:.3f} s")
    with Phase("train", cuda_sync):
        train = phase_train(device)
        paths["train"] = train["flagship"]["launches"]
        check(paths["train"] == 0,
              f"training launched fused_decoder {paths['train']} times")
    summary.append(f"train {train['flagship']['wall_s_per_step']:.4f} s/step, peak "
                   f"{train['flagship']['peak_gb']:.3f} GB")
    with Phase("recon", cuda_sync):
        recon = phase_recon(device)
        paths["recon_train"] = recon["flagship"]["launches"]
        paths["recon_ft"] = recon["ft"]["launches"]
        paths["recon eval"] = recon["eval"]["launches"]
        paths["recon_test"] = recon["test"]["launches"]
    flag = recon["flagship"]
    summary.append(f"recon_train {flag['wall_s_per_step']:.4f} s/step "
                   f"({flag['event_ms_per_step']:.3f} device ms, busy {flag['busy']:.4f}), "
                   f"peak {flag['peak_gb']:.3f} GB, save {flag['saves'][-1][1]:.3f} s / "
                   f"{flag['saves'][-1][2]:.3f} GB; eval vs JAX max "
                   f"{recon['eval']['max_abs_gap_db']:.5f} dB")
    with Phase("canonical", cuda_sync):
        canon = phase_canonical(device)
        paths["canonical train"] = canon["flagship"]["launches"]
        paths.update(canon["eval"]["paths"])
    cf = canon["flagship"]
    summary.append(f"canonical {cf['wall_s_per_step']:.4f} s/step ({cf['event_ms_per_step']:.3f} "
                   f"device ms, busy {cf['busy']:.4f}, deform share {cf['deform_share']:.4f}), "
                   f"peak {cf['peak_gb']:.3f} GB; 1-NN {canon['deform']['nn_ms']:.3f} ms, deform "
                   f"{canon['deform']['deform_ms']:.3f} ms; exact vs JAX "
                   f"{canon['eval']['exact_vs_jax_db']:.3f} dB")

    with Phase("quality", cuda_sync):
        quality = phase_quality(device)
        paths.update(quality["paths"])
    qs = quality["stage2"]["seconds"]
    summary.append(f"refit {quality['refit']['wall_s_per_step']:.4f} s/step; quality_eval "
                   f"{quality['eval']['eval_s']:.3f} s (vs JAX max "
                   f"{quality['eval']['max_abs_gap_db']:.5f} dB); quality_stage2 "
                   f"{quality['stage2']['stage2_s']:.3f} s (ft {qs['ft']:.3f}, train "
                   f"{qs['train']:.3f}, sample {qs['sample']:.3f}, decode {qs['decode']:.3f}), "
                   f"peak {quality['stage2']['peak_gb']:.3f} GB; chain costs "
                   f"{json.dumps(quality['chain']['costs'])}; bench_decode exact / fast "
                   f"{quality['bench']['result']['exact_s_per_view_median']:.4f} / "
                   f"{quality['bench']['result']['fast_s_per_view_median']:.4f} s/view")

    say(f"summary: {'; '.join(summary)}; total {time.perf_counter() - t_start:.3f} s")
    say(f"[kernel] main-path shapes: {json.dumps(kern['main_shapes'])}; backward of a Stage-1 "
        f"fine pass {kern['stage1_backward_ms']:.4f} ms; on a canonical fine pass's inputs "
        f"{canon['descent']['kernel_err']:.3e} max abs")
    say(json.dumps({"kernels": [{
        "name": "fused_decoder",
        "route": "cuda",
        "source": "humanliff_tpu_torch/csrc/fused_decoder.cu",
        "replaces": "humanliff_tpu/ops/pallas/decoder.py:80",
        "launches": sum(paths.values()),
        "launches_by_path": paths,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound"]["ms"],
        "bound_by": kern["bound"]["by"],
        "bound_term": kern["bound"]["term"],
        "library_ms": None,
        "main_shapes": kern["main_shapes"],
        "stage1_backward_ms": kern["stage1_backward_ms"],
        "canonical_fine_pass_max_abs_err": canon["descent"]["kernel_err"],
    }]}))
    say(nvidia_smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
