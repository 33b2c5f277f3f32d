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
              tile); CUDA-event times beside the bound (decoder_bound_ms)  120 s
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

Launch counts are set to 0 just before each path (the 4-layer generation and
exact decode, each grid build, each fast view, the fitted exact view, the
mesh, the CLI, training) and read just after it; training renders nothing
and must launch the decoder kernel 0 times. The last three lines are a
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
BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)  # bench.py:200
BUDGET_S = {"build": 120, "kernel": 120, "generate": 420, "decode": 180, "mesh": 120,
            "cli": 360, "train": 300}
RENDER_CHUNK = 16384  # rays per render_rays call (render_image_masked's default)
GRID_RESOLUTION = 128  # the CLI's --grid_resolution default
GRID_CHUNK = 1 << 22  # lattice points per decoder call of build_density_grid
MESH_RESOLUTION = 512  # the CLI's --mesh_resolution default
MESH_CHUNK = 1 << 22  # points per decoder call of eval_density_grid
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
                 reps=10) -> dict:
    """Hold the kernel against decoder_plain and time both, at the sizes given
    and at every shape the main path launches."""
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
    checks = [(M, dt, full) for M in sizes for dt in ("float32", "bfloat16")
              for full in (True, False)] + main_shapes
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
        shapes = [(M, dt, full) for M in time_sizes for dt in ("float32", "bfloat16")
                  for full in (True, False)] + main_shapes
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
    k_ms, p_ms, b = timings[(main_fine_points, "bfloat16", True)]
    shapes = [{"M": M, "dtype": dt, "variant": "full" if full else "density",
               "ms": timings[(M, dt, full)][0], "plain_ms": timings[(M, dt, full)][1],
               "bound_ms": timings[(M, dt, full)][2]["ms"]} for M, dt, full in main_shapes]
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound": b,
            "main_shapes": shapes}


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

    with Phase("build", cuda_sync):
        build = phase_build()
    with Phase("kernel", cuda_sync):
        kern = phase_kernel(device)

    # The main path, path by path; each reads fused_decoder's launches from 0.
    paths = {}
    kernels.reset_launches()
    with Phase("generate", cuda_sync):
        gen = phase_generate(device, args.steps)
    with Phase("decode", cuda_sync):
        dec = phase_decode(device, gen["layers"]["person_pant_shirt_shoes"])
        expect_launches(device, dec["launches"], 2 * math.ceil(dec["n_rays"] / RENDER_CHUNK),
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
    with Phase("mesh", cuda_sync):
        mesh = phase_mesh(device)
        paths[f"mesh {MESH_RESOLUTION}^3 (fitted)"] = mesh["launches"]
    with Phase("cli", cuda_sync):
        cli = phase_cli(device, gen["layers"]["person_pant_shirt"], args.cli_steps,
                        cli_flags=("--mesh_resolution", str(CLI_MESH_RESOLUTION)))
        paths["cli"] = cli["launches"]
    with Phase("train", cuda_sync):
        train = phase_train(device)
        paths["train"] = train["flagship"]["launches"]
        check(paths["train"] == 0, f"training launched fused_decoder {paths['train']} times")

    say(f"summary: build {build['seconds']:.3f} s, generation "
        f"{sum(gen['per_layer_s']):.3f} s ({gen['steps']} steps x 4 layers; per layer "
        f"{', '.join(f'{s:.3f}' for s in gen['per_layer_s'])} s); 512^2 view 0, exact / "
        f"fast (grid + render): generated {dec['render_s']:.3f} / {fast['render_s']:.3f} s, "
        f"fitted {fitted['render_s']:.3f} / {fast_fit['render_s']:.3f} s; mesh "
        f"{MESH_RESOLUTION}^3 {mesh['mesh_s']:.3f} s; cli {cli['cli_s']:.3f} s; train "
        f"{train['flagship']['wall_s_per_step']:.4f} s/step, peak "
        f"{train['flagship']['peak_gb']:.3f} GB; total "
        f"{time.perf_counter() - t_start:.3f} s")
    say(f"[kernel] main-path shapes: {json.dumps(kern['main_shapes'])}")
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
