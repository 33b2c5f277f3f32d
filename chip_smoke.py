#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``humanliff_tpu_torch``) once on one NVIDIA H100.

    python3 chip_smoke.py [--steps 250]

The main path is flagship inference, what ``bench.py`` times for the JAX
package: four chained layers of the ControlNet UNet at full width
(27 x 256 x 256, 192 channels, 3 res blocks, attention at 32/16/8, y = k,
``timestep_respacing="250"`` DDPM at B = 1, seeded random weights, bf16
autocast, channels_last), then the exact 512^2 decode of the last layer
(``planes_image_to_triplane`` -> ``render_image_masked``, 128 + 128 samples,
orbit camera 0) with the fitted Stage-1 decoder of ``runs/quality/train``.

Phases, each printed with its seconds and failed past its budget:

    build     nvcc builds csrc/fused_decoder.cu into build/torch_kernels/;
              ptxas' registers and spills (none allowed) and the HMMA count
              of each kernel variant from cuobjdump -sass                  120 s
    kernel    fused decoder vs its plain version (fitted weights, features
              sampled from fitted planes), M = 2^20 and 1,000,003, fp32 and
              bf16 inputs, full and density-only, and the main path's two
              shapes (a render chunk's passes); CUDA-event times beside the
              bound (decoder_bound_ms) and its one-pass basis              120 s
    generate  the 4-layer chain; one bf16 UNet forward is first held
              against the fp32 forward                                    420 s
    decode    the 512^2 exact render through the kernel (launch count
              checked), a CPU re-render of a ray subset with the plain
              decoder, and a decode of fitted campaign planes              180 s

The last three lines are a ``{"kernels": [...]}`` record, the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``. Any failed
check or blown budget exits non-zero before the result. Without CUDA, or run
outside a checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DECODER_NPZ = os.path.join(REPO, "runs", "quality", "train", "decoder_060000.npz")
PLANES_NPZ = os.path.join(REPO, "runs", "quality", "stage2", "planes",
                          "campaign0000_060000.npz")
BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)  # bench.py:200
BUDGET_S = {"build": 120, "kernel": 120, "generate": 420, "decode": 180}
RENDER_CHUNK = 16384  # rays per render_rays call (render_image_masked's default)

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
                 main_fine_points=RENDER_CHUNK * 256, reps=10) -> dict:
    """Hold the kernel against decoder_plain and time both."""
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

    # The main path's shapes: a render chunk's fine pass (bf16, full) and
    # coarse pass (bf16, density-only).
    main_shapes = [(main_fine_points, "bfloat16", True),
                   (main_fine_points // 2, "bfloat16", False)]
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
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound": b}


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


def phase_decode(device, last_layer, image_size=512, n_samples=128,
                 n_check_rays=256) -> dict:
    import torch

    from humanliff_tpu_torch import kernels
    from humanliff_tpu_torch.data.raygen import full_image_rays
    from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
    from humanliff_tpu_torch.nerf.renderer import (
        RenderConfig,
        render_image_masked,
        render_rays,
    )
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
    if device.type == "cuda":
        torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = kernels.LAUNCHES["fused_decoder"]
    n_rays = int(mask.sum())
    acc = out["acc"].float().cpu().numpy()
    rgb = out["rgb"].float().cpu().numpy()
    stats = acc_stats(acc, mask)
    say(f"[decode] {S}^2 view, {n_rays} rays in the box, {2 * n_samples} samples/ray: "
        f"{render_s:.3f} s; acc {json.dumps(stats)}")
    check(np.isfinite(rgb).all() and np.isfinite(acc).all(), "non-finite render")
    check(acc.min() >= 0.0 and acc.max() <= 1.0 + 1e-4, "acc leaves [0, 1]")

    # The same rays on the CPU through render_rays with the plain decoder.
    from humanliff_tpu_torch.nerf.decoder import NeRFDecoder

    idx = np.flatnonzero(mask)[:: max(1, n_rays // n_check_rays)][:n_check_rays]
    dec_cpu = NeRFDecoder()
    dec_cpu.load_state_dict({k: v.cpu() for k, v in dec.state_dict().items()})
    with torch.no_grad():
        ref = render_rays(dec_cpu, planes.cpu(), *(torch.from_numpy(a[idx]) for a in
                                                    (ro, rd, near, far)),
                          torch.from_numpy(BOUNDS), cfg)
    psnrs = {}
    for k in ("rgb", "acc"):
        mse = float(np.mean((out[k].float().cpu().numpy()[idx] - ref[k].numpy()) ** 2))
        psnrs[k] = float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)
    say(f"[decode] {len(idx)} rays vs CPU plain render: PSNR rgb {psnrs['rgb']:.2f} dB, "
        f"acc {psnrs['acc']:.2f} dB (bar 45 dB)")
    check(min(psnrs.values()) >= 45.0, f"render disagrees with the CPU plain path: {psnrs}")
    return {"render_s": render_s, "launches": launches, "n_rays": n_rays,
            "stats": stats, "psnr": psnrs, "ray_args": (ro, rd, near, far, mask, cfg)}


def phase_fitted_planes(device, ray_args) -> dict:
    """Decode layer 3 of the fitted campaign planes with the same camera: a
    real subject gives a silhouette (mostly saturated acc), not noise."""
    import torch

    from humanliff_tpu_torch.nerf.renderer import render_image_masked

    ro, rd, near, far, mask, cfg = ray_args
    dec = load_fitted_decoder(device)
    planes = load_fitted_planes(3).to(device=device, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    out = render_image_masked(dec, planes, ro, rd, near, far, mask, BOUNDS, cfg)
    acc = out["acc"].float().cpu().numpy()
    stats = acc_stats(acc, mask)
    say(f"[decode] fitted campaign0000 layer 3: {time.perf_counter() - t0:.3f} s; "
        f"acc {json.dumps(stats)}")
    check(np.isfinite(acc).all(), "non-finite render of the fitted planes")
    check(0.05 <= stats["frac_gt_0.5"] <= 0.95 and stats["frac_saturated"] >= 0.5,
          f"fitted planes give no silhouette: {stats}")
    return stats


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
    sync = torch.cuda.synchronize
    t_start = time.perf_counter()

    with Phase("build", sync):
        build = phase_build()
    with Phase("kernel", sync):
        kern = phase_kernel(device)

    # The main path: generation, then the exact decode. Counts start at 0 here.
    kernels.reset_launches()
    with Phase("generate", sync):
        gen = phase_generate(device, args.steps)
    with Phase("decode", sync):
        dec = phase_decode(device, gen["layers"]["person_pant_shirt_shoes"])
        launches = kernels.LAUNCHES["fused_decoder"]
        expected = 2 * math.ceil(dec["n_rays"] / RENDER_CHUNK)
        say(f"[decode] fused_decoder launches on the main path: {launches} "
            f"(expected {expected}: coarse + fine per {RENDER_CHUNK}-ray chunk)")
        check(launches == expected and launches > 0,
              f"main path launched fused_decoder {launches} times, expected {expected}")
        phase_fitted_planes(device, dec["ray_args"])

    say(f"summary: build {build['seconds']:.3f} s, generation "
        f"{sum(gen['per_layer_s']):.3f} s ({gen['steps']} steps x 4 layers; per layer "
        f"{', '.join(f'{s:.3f}' for s in gen['per_layer_s'])} s), decode "
        f"{dec['render_s']:.3f} s, total {time.perf_counter() - t_start:.3f} s")
    say(json.dumps({"kernels": [{
        "name": "fused_decoder",
        "route": "cuda",
        "source": "humanliff_tpu_torch/csrc/fused_decoder.cu",
        "replaces": "humanliff_tpu/ops/pallas/decoder.py:80",
        "launches": launches,
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
