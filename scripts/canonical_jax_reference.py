#!/usr/bin/env python3
"""The JAX package's canonical-space (TightCap) numbers on the committed
fitted decoder and planes, the reference that ``chip_smoke.py``'s canonical
phase and ``tests/test_torch_canonical.py`` hold the port to.

    JAX_PLATFORMS=cpu python3 scripts/canonical_jax_reference.py \\
        [--out runs/quality/canonical_jax_reference.npz]

The body is ``make_synthetic_body_model(J=24, V=6890, n_betas=10, seed=0)``
(SMPL's array shapes; no SMPL file), posed by seeded poses and betas and
placed in the world by a seeded rotation R and a translation Th of 2.6 m,
with the big pose of ``big_pose_params(72)``. One orbit camera looks at the
posed body. The scene is the Stage-1 campaign's fitted decoder
(``runs/quality/train/decoder_060000.npz``) and layer 3 of its first
subject's planes (``runs/quality/stage2/planes/campaign0000_060000.npz``),
read in the big pose's bounds (TightCap's box_warp). It writes one npz with

- the scene: camera ``K``, ``R_cam``, ``T_cam``, ``image_size``, the SMPL
  arrays ``poses``, ``betas``, ``t_poses``, ``R``, ``Th``, ``smpl_verts``,
  ``box_warp`` (big pose) and ``world_bounds`` (posed, for near and far);
- ``rgb``, ``acc`` (N,) and ``mask``: the exact tier's 128^2 render
  (``render_image_masked``, 128 + 128 samples) through
  ``make_eval_deform_fn``;
- ``fast_vs_exact_db``: the fast tier's (``build_density_grid`` at 128^3,
  ``render_image_fast``, early_term_eps 1e-2) PSNR against the exact tier
  over the in-box rays;
- ``query_pts``, ``query_dirs`` (4,096 world points around the posed body
  and directions), ``query_ids`` (the batched 1-NN's vertex per point) and
  ``can_pts``, ``can_dirs`` (the eval deform of them).

This script imports JAX and the JAX package on purpose; the card has
neither. The JAX batched deform holds each chunk's (M, 6,890) distances at
once, so it renders 256 rays a chunk; about two minutes on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DECODER = "runs/quality/train/decoder_060000.npz"
PLANES = "runs/quality/stage2/planes/campaign0000_060000.npz"
LAYER = 3
IMAGE_SIZE = 128
N_SAMPLES = 128
GRID_RESOLUTION = 128
EARLY_TERM_EPS = 1e-2
N_QUERY = 4096
CHUNK = 256  # rays per render call: the JAX deform's distances, 1.8 GB a chunk


def rotation(axis, angle: float) -> np.ndarray:
    """Rodrigues' rotation about ``axis`` by ``angle`` radians."""
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.asarray([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def orbit_camera(bounds: np.ndarray, S: int, theta: float = 0.7):
    """(K, R, T) of a camera on an orbit around the box ``bounds``, looking at
    its centre from 2.5 times its largest side, the box about 60 % of the
    image."""
    c = bounds.mean(0).astype(np.float64)
    e = float((bounds[1] - bounds[0]).max())
    d = 2.5 * e
    eye = c + d * np.asarray([np.cos(theta), 0.15, np.sin(theta)]) / np.linalg.norm(
        [np.cos(theta), 0.15, np.sin(theta)])
    fwd = (c - eye) / np.linalg.norm(c - eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, -np.cross(right, fwd), fwd], axis=0)
    T = (-R @ eye).reshape(3, 1)
    f = 0.6 * S * d / e
    K = np.asarray([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]])
    return K, R, T


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "quality",
                                                  "canonical_jax_reference.npz"))
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from humanliff_tpu.bodymodel.bigpose import big_pose_params
    from humanliff_tpu.bodymodel.canonical import make_eval_deform_fn
    from humanliff_tpu.bodymodel.smpl import lbs_forward, make_synthetic_body_model
    from humanliff_tpu.data.raygen import full_image_rays
    from humanliff_tpu.data.tightcap import _bounds_from_verts
    from humanliff_tpu.nerf.decoder import NeRFDecoder
    from humanliff_tpu.nerf.fastpath import build_density_grid, render_image_fast
    from humanliff_tpu.nerf.renderer import RenderConfig, render_image_masked
    from humanliff_tpu.train.checkpoint import load_decoder_npz

    t0 = time.time()
    body = make_synthetic_body_model(J=24, V=6890, n_betas=10, seed=0)
    rng = np.random.default_rng(0)
    poses = rng.normal(scale=0.2, size=72).astype(np.float32)
    betas = rng.normal(scale=0.5, size=10).astype(np.float32)
    Rg = rotation(rng.normal(size=3), 0.6).astype(np.float32)
    Th = np.asarray([1.5, -0.6, 2.0], np.float32)
    t_poses = big_pose_params(72)
    smpl_verts = np.asarray(lbs_forward(body, jnp.asarray(poses[None]),
                                        jnp.asarray(betas[None]))[0][0])
    world_bounds = _bounds_from_verts(smpl_verts @ Rg.T + Th)
    t_verts = np.asarray(lbs_forward(body, jnp.asarray(t_poses[None]),
                                     jnp.zeros((1, 10)))[0][0])
    box = _bounds_from_verts(t_verts)
    S = IMAGE_SIZE
    K, R_cam, T_cam = orbit_camera(world_bounds, S)
    ro, rd, near, far, mask = full_image_rays(S, S, K, R_cam, T_cam, world_bounds)
    deform_args = {"poses": poses, "betas": betas, "t_poses": t_poses, "R": Rg, "Th": Th,
                   "smpl_verts": smpl_verts}
    deform = make_eval_deform_fn(body)

    decoder = NeRFDecoder()
    params = load_decoder_npz(os.path.join(REPO, DECODER))
    with np.load(os.path.join(REPO, PLANES)) as z:
        planes = jnp.asarray(np.asarray(z["tri_planes"][LAYER], np.float32))
    cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_SAMPLES, perturb=False,
                       density_noise=False)
    exact = render_image_masked(decoder, params, planes, ro, rd, near, far, mask, box, cfg,
                                chunk=CHUNK, deform_fn=deform, deform_args=deform_args)
    t_exact = time.time() - t0
    grid = build_density_grid(decoder, params, planes, box, resolution=GRID_RESOLUTION)
    fast = render_image_fast(decoder, params, planes, grid, ro, rd, near, far, mask, box, cfg,
                             chunk=CHUNK, coarse_chunk=CHUNK, deform_fn=deform,
                             deform_args=deform_args, early_term_eps=EARLY_TERM_EPS,
                             outputs=("rgb",))
    sel = mask.astype(bool)
    mse = float(np.mean((fast["rgb"][sel].astype(np.float64) - exact["rgb"][sel]) ** 2))
    fast_db = 10 * np.log10(1.0 / mse)

    qrng = np.random.default_rng(1)
    world = smpl_verts @ Rg.T + Th
    query_pts = (world[qrng.integers(0, 6890, N_QUERY)]
                 + qrng.normal(scale=0.05, size=(N_QUERY, 3))).astype(np.float32)
    query_dirs = qrng.normal(size=(N_QUERY, 3)).astype(np.float32)
    can_pts, can_dirs = deform(jnp.asarray(query_pts), jnp.asarray(query_dirs), deform_args)
    # The batched 1-NN's ids of the query in SMPL space (canonical.py:69-75).
    q = (jnp.asarray(query_pts) - Th) @ Rg
    d = (jnp.asarray(smpl_verts) ** 2).sum(-1)[None] - 2.0 * jnp.einsum(
        "md,vd->mv", q.astype(jnp.bfloat16), jnp.asarray(smpl_verts).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32)
    query_ids = np.asarray(jnp.argmin(d, axis=-1)).astype(np.int32)

    out = dict(
        K=K, R_cam=R_cam, T_cam=T_cam, image_size=np.int32(S), n_samples=np.int32(N_SAMPLES),
        grid_resolution=np.int32(GRID_RESOLUTION), early_term_eps=np.float32(EARLY_TERM_EPS),
        layer=np.int32(LAYER), box_warp=box, world_bounds=world_bounds, **deform_args,
        rgb=exact["rgb"].astype(np.float32), acc=exact["acc"].astype(np.float32), mask=sel,
        fast_vs_exact_db=np.float64(fast_db), query_pts=query_pts, query_dirs=query_dirs,
        query_ids=query_ids, can_pts=np.asarray(can_pts, np.float32),
        can_dirs=np.asarray(can_dirs, np.float32),
        v_template_sum=np.float64(body.v_template.astype(np.float64).sum()))
    np.savez_compressed(args.out, **out)
    acc = exact["acc"][sel]
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes) in {time.time() - t0:.1f} s "
          f"(exact render {t_exact:.1f} s): {int(sel.sum())} in-box rays, acc mean "
          f"{acc.mean():.4f}, lit share {(acc > 0.5).mean():.4f}; fast vs exact "
          f"{fast_db:.4f} dB; box {box.tolist()}; world bounds {world_bounds.tolist()}")
    return out


if __name__ == "__main__":
    main()
