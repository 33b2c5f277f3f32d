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

Launch counts are set to 0 just before each path (the 4-layer generation and
exact decode, each grid build, each fast view, the fitted exact view, the
mesh, the CLI, Stage-2 training, recon_train, recon_ft, the Stage-1 eval,
recon_test) and read just after it; Stage-2 training renders nothing and
must launch the decoder kernel 0 times, a Stage-1 step exactly twice (the
coarse and the fine pass). The last three lines are a
``{"kernels": [...]}`` record, the card's name and power limit from
nvidia-smi, and ``{"ok": true, "device": {...}}``. Any failed check or blown
budget exits non-zero before the result. Without CUDA, or run outside a
checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
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
BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)  # bench.py:200
BUDGET_S = {"build": 120, "kernel": 120, "generate": 420, "decode": 180, "mesh": 120,
            "cli": 360, "train": 300, "recon": 240}
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


def kept_rays(grid, rays, box, cfg, eps: float):
    """The fast tier's keep flag (R,) of in-box rays (rays_o, rays_d, near,
    far on the device) at ``early_term_eps`` ``eps``, from the grid's coarse
    phase in render_image_fast's chunks; no decoder call."""
    import torch

    from humanliff_tpu_torch.nerf.fastpath import coarse_from_grid

    n = rays[0].shape[0]
    keep = []
    for s in range(0, n, COARSE_CHUNK):  # FAST_GROUP is a multiple of COARSE_CHUNK
        _, acc_est = coarse_from_grid(grid, *(r[s:s + COARSE_CHUNK] for r in rays), box, cfg)
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


def _recon_small_card_vs_cpu(device) -> dict:
    """Check 1: one deterministic Stage-1 step at a small width (2 instances,
    4 layers, D 32, 64 rays, 16 + 16 samples, the fitted decoder) on the card
    and on the CPU."""
    import torch

    from humanliff_tpu_torch.data.synthetic import SyntheticLayeredDataset
    from humanliff_tpu_torch.nerf.decoder import flatten_state_dict
    from humanliff_tpu_torch.nerf.renderer import RenderConfig
    from humanliff_tpu_torch.train.optim import make_stage1_optimizer
    from humanliff_tpu_torch.train.stage1 import Stage1Config, create_train_state, train_step

    cfg = Stage1Config(num_instances=2, triplane_dim=32,
                       render=RenderConfig(n_samples=16, n_importance=16, perturb=False,
                                           density_noise=False))
    planes = torch.from_numpy(stage1_fixture_planes(2, 4, 32))
    flat = flatten_state_dict(load_fitted_decoder("cpu").state_dict())
    ds = SyntheticLayeredDataset(num_instances=2, n_rays=64, image_size=32, tight_bounds=True)
    items = [(1 * 64 + 3, 1), (256 + 3 * 64 + 17, 2)]  # (0, layer 1), (1, layer 3)
    runs = []
    for dev in (device, torch.device("cpu")):
        state = create_train_state({"planes": planes.to(dev, copy=True),
                                    "decoder": flat.to(dev, copy=True)},
                                   make_stage1_optimizer())
        aux = train_step(state, stage1_batch(ds, items, dev), cfg)
        runs.append((state, {k: float(v) for k, v in aux.items()}))
    (card, m_card), (cpu, m_cpu) = runs
    out = {}
    for k, v in m_cpu.items():
        rel = abs(m_card[k] - v) / max(abs(v), 1e-30)
        check(rel <= RECON_SMALL_METRIC_REL, f"recon small: {k} {m_card[k]} vs {v}")
        out[f"metric_{k}"] = rel
    for group, lr in (("planes", 1e-1), ("decoder", 5e-3)):
        mu_card, mu_cpu = card.opt_state[group]["mu"], cpu.opt_state[group]["mu"]
        rel = float((mu_card.double().cpu() - mu_cpu.double()).norm() / mu_cpu.double().norm())
        check(rel <= RECON_SMALL_MOMENT_REL, f"recon small: {group} first moment {rel}")
        out[f"{group}_mu_rel_l2"] = rel
        # After one step the first moment is 0.1 x the gradient.
        out[group] = near_zero_apart(card.params[group], cpu.params[group], mu_cpu / 0.1, lr,
                                     f"recon small {group}")
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

    say(f"summary: {'; '.join(summary)}; total {time.perf_counter() - t_start:.3f} s")
    say(f"[kernel] main-path shapes: {json.dumps(kern['main_shapes'])}; backward of a Stage-1 "
        f"fine pass {kern['stage1_backward_ms']:.4f} ms")
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
