"""Port parity of canonical space (``bodymodel/canonical.py`` and the
``deform_fn`` paths of ``nerf/renderer.py``, ``nerf/fastpath.py``,
``nerf/geometry.py``, ``eval/harness.py`` and ``train/stage1.py``) against
the JAX package, on the CPU in fp32, on seeded toy bodies.

Bars:
- the deform at SMPL's shapes (V 6,890, M 4,096 a item, the seeded
  SMPL-shaped body): nearest-vertex ids equal to JAX's on every point, both
  paths; points and directions within 1e-5 (measured 3.8e-6 at coordinates
  up to 5 m). A product whose output is rounded to bf16 picks other
  vertices for most points (measured 80 %): the batched 1-NN rounds its
  operands, not its products.
- renders with a deform: the world-space tests' bars (rgb and acc 2e-5,
  depth 1e-4, tests/test_torch_recon_cli.py; the fast tier 1e-3 and the
  same terminated rays, tests/test_torch_fastpath.py; the density grid
  1e-4, tests/test_torch_geometry.py).
- the canonical Stage-1 step: tests/test_torch_stage1.py's bars (loss rtol
  1e-5, gradients relative L2 1e-5, the alpha head 1e-4; Adam steps by
  ``torch_stage1_util.near_zero_rule``, the second step from JAX's state).
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_stage1_util as U
from humanliff_tpu.bodymodel import canonical as jcan
from humanliff_tpu.bodymodel import smpl as jsmpl
from humanliff_tpu.eval import harness as jharness
from humanliff_tpu.nerf import fastpath as jfp
from humanliff_tpu.nerf import geometry as jgeometry
from humanliff_tpu.nerf import renderer as jrender
from humanliff_tpu.train import optim as joptim
from humanliff_tpu.train import stage1 as jstage1
from humanliff_tpu_torch.bodymodel import canonical, smpl
from humanliff_tpu_torch.compat.from_jax import stage1_state_from_arrays
from humanliff_tpu_torch.data.raygen import full_image_rays
from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
from humanliff_tpu_torch.eval.harness import evaluate_views
from humanliff_tpu_torch.nerf import fastpath, geometry
from humanliff_tpu_torch.nerf.decoder import FlatDecoder, NeRFDecoder
from humanliff_tpu_torch.nerf.renderer import (
    RenderConfig,
    bind_deform,
    render_image_masked,
    render_rays_batch,
)
from humanliff_tpu_torch.train import optim
from humanliff_tpu_torch.train.stage1 import (
    canonical_deform,
    create_train_state,
    restore_into,
    stage1_loss,
    train_step,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import export_jax_weights  # noqa: E402

KEYS = ("poses", "betas", "t_poses", "R", "Th", "smpl_verts")
BOX = np.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rot(theta, axis):
    c, s = np.cos(theta), np.sin(theta)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R.astype(np.float32)


# ---------------- the deform at SMPL's shapes ----------------


@pytest.fixture(scope="module")
def smpl_scene():
    """The seeded SMPL-shaped body, two posed items and 4,096 query points
    around each posed body, with directions."""
    jm = jsmpl.make_synthetic_body_model(24, 6890, 10, 0)
    pm = smpl.make_synthetic_body_model(24, 6890, 10, 0)
    rng = np.random.default_rng(0)
    B, M = 2, 4096
    poses = rng.normal(scale=0.3, size=(B, 72)).astype(np.float32)
    betas = rng.normal(scale=1.0, size=(B, 10)).astype(np.float32)
    big = np.stack([np.zeros(72, np.float32), rng.normal(scale=0.1, size=72)]).astype(np.float32)
    verts = np.asarray(jsmpl.lbs_forward(jm, jnp.asarray(poses), jnp.asarray(betas))[0])
    near = verts[np.arange(B)[:, None], rng.integers(0, 6890, size=(B, M))]
    pts = (near + rng.normal(scale=0.05, size=(B, M, 3))).astype(np.float32)
    dirs = rng.normal(size=(B, M, 3)).astype(np.float32)
    return dict(jm=jm, pm=pm, args=(poses, betas, big, verts, pts, dirs))


def _jax_batched_ids(pts, verts):
    """JAX's batched 1-NN ids (canonical.py:69-75)."""
    v_sq = (jnp.asarray(verts) ** 2).sum(-1)
    d = v_sq[:, None, :] - 2.0 * jnp.einsum(
        "bmd,bvd->bmv", jnp.asarray(pts).astype(jnp.bfloat16),
        jnp.asarray(verts).astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    return np.asarray(jnp.argmin(d, axis=-1))


def test_batched_deform_matches_jax(smpl_scene):
    """Ids on every point, in one tile and in tiles of 1,000 points; points
    and dirs within 1e-5."""
    args = smpl_scene["args"]
    poses, betas, big, verts, pts, dirs = args
    want_p, want_d = jcan.deform_to_canonical_batched(smpl_scene["jm"],
                                                      *(jnp.asarray(a) for a in args))
    got_p, got_d = canonical.deform_to_canonical_batched(smpl_scene["pm"], *map(_t, args))
    want_ids = _jax_batched_ids(pts, verts)
    for tile in (canonical.NN_TILE, 1000):
        ids = canonical.nearest_vertex_batched(_t(pts), _t(verts), tile=tile).numpy()
        np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)
    assert got_p.requires_grad is False


def test_a_bf16_output_product_picks_other_vertices(smpl_scene):
    """The trap the batched 1-NN avoids: ``torch.bmm`` of bf16 tensors rounds
    each distance's product to bf16, and the argmin then disagrees with JAX
    on most points (measured 80 %)."""
    _, _, _, verts, pts, _ = smpl_scene["args"]
    v_sq = _t(verts).pow(2).sum(-1)[:, None, :]
    rounded = torch.bmm(_t(pts).bfloat16(), _t(verts).bfloat16().mT).float()
    ids = torch.argmin(v_sq - 2.0 * rounded, dim=-1).numpy()
    agree = float((ids == _jax_batched_ids(pts, verts)).mean())
    assert agree < 0.9, agree


@pytest.mark.parametrize("b", [0, 1])
def test_single_item_deform_matches_jax(smpl_scene, b):
    """The fp32 1-NN (tiled at 1,000 points here) and the LU inverse."""
    item = [a[b] for a in smpl_scene["args"]]
    pts, verts = item[4], item[3]
    want_p, want_d = jcan.deform_to_canonical(smpl_scene["jm"], *(jnp.asarray(a) for a in item))
    got_p, got_d = canonical.deform_to_canonical(smpl_scene["pm"], *map(_t, item))
    np.testing.assert_array_equal(
        canonical.nearest_vertex(_t(pts), _t(verts), tile=1000).numpy(),
        np.asarray(jcan.nearest_vertex(jnp.asarray(pts), jnp.asarray(verts))))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)


def test_canonicalization_roundtrip():
    """Posed vertices land on the big-posed mean-shape vertices through the
    single-item deform (JAX tests/test_bodymodel.py's property, on the port;
    the batched path's bf16 1-NN may pick a neighbour of a vertex that is its
    own query)."""
    pm = smpl.make_synthetic_body_model(J=4, V=64)
    rng = np.random.default_rng(3)
    poses = _t(rng.normal(scale=0.4, size=(1, 12)).astype(np.float32))
    betas = _t(rng.normal(size=(1, 5)).astype(np.float32))
    big = _t(rng.normal(scale=0.3, size=(12,)).astype(np.float32))
    posed, _ = smpl.lbs_forward(pm, poses, betas)
    target, _ = smpl.lbs_forward(pm, big[None], torch.zeros(1, 5))
    can, _ = canonical.deform_to_canonical(pm, poses[0], betas[0], big, posed[0], posed[0])
    torch.testing.assert_close(can, target[0], atol=1e-4, rtol=0)


# ---------------- a small canonical scene ----------------


@pytest.fixture(scope="module")
def scene():
    """A toy body (J 4, V 48, the JAX tests'), two posed items with global
    R and Th, the D-16 plane table and decoder of torch_stage1_util."""
    jm = jsmpl.make_synthetic_body_model(J=4, V=48)
    pm = smpl.make_synthetic_body_model(J=4, V=48)
    rng = np.random.default_rng(5)
    B = 2
    poses = rng.normal(scale=0.2, size=(B, 12)).astype(np.float32)
    betas = rng.normal(scale=0.5, size=(B, 5)).astype(np.float32)
    verts = np.asarray(jsmpl.lbs_forward(jm, jnp.asarray(poses), jnp.asarray(betas))[0])
    smplv = {"poses": poses, "betas": betas,
             "t_poses": rng.normal(scale=0.1, size=(B, 12)).astype(np.float32),
             "R": np.stack([_rot(0.3, 2), _rot(-0.5, 1)]),
             "Th": np.asarray([[0.1, -0.2, 0.05], [-0.3, 0.1, 0.2]], np.float32),
             "smpl_verts": verts}
    dec, dvars, dflat = U.decoder_vars(0)
    return dict(jm=jm, pm=pm, smpl=smplv, dec=dec, dvars=dvars, dflat=dflat,
                planes=U.plane_table(0))


def _ray_batch(scene, R=32, seed=0):
    rng = np.random.default_rng(seed)
    B = 2
    batch = {
        "instance_idx": np.asarray([0, 1], np.int32), "layer_idx": np.asarray([1, 0], np.int32),
        "rays_o": np.tile(np.asarray([[0.5, 0.5, 3.0]], np.float32), (B, R, 1)),
        "rays_d": (rng.normal(size=(B, R, 3)) * 0.25 + [0, 0, -1]).astype(np.float32),
        "near": np.full((B, R), 2.0, np.float32), "far": np.full((B, R), 4.5, np.float32),
        "box_warp": np.broadcast_to(BOX, (B, 2, 3)).copy(),
        "rgb": rng.uniform(size=(B, R, 3)).astype(np.float32),
        "bkgd_msk": (rng.uniform(size=(B, R)) < 0.5).astype(np.float32),
        "ray_mask": np.ones((B, R), np.float32),
    }
    batch.update(scene["smpl"])
    return batch


def _jax_train_deform(jm, batch):
    """JAX stage1.py:137-145's deform, for its batched renderer."""
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def deform(pts, dirs):
        pts = jnp.einsum("bmd,bde->bme", pts - b["Th"][:, None], b["R"])
        if dirs is not None:
            dirs = jnp.einsum("bmd,bde->bme", dirs - b["Th"][:, None], b["R"])
        return jcan.deform_to_canonical_batched(jm, b["poses"], b["betas"], b["t_poses"],
                                                b["smpl_verts"], pts, dirs)
    return deform


def test_render_rays_batch_with_deform_matches_jax(scene):
    batch = _ray_batch(scene)
    cfg = dict(n_samples=8, n_importance=8, perturb=False, density_noise=False)
    planes = scene["planes"][[0, 1], [1, 0]]
    want = jrender.render_rays_batch(
        scene["dec"], scene["dvars"], jnp.asarray(planes),
        *(jnp.asarray(batch[k]) for k in ("rays_o", "rays_d", "near", "far", "box_warp")),
        jrender.RenderConfig(**cfg), deform_fn=_jax_train_deform(scene["jm"], batch))
    with torch.no_grad():
        got = render_rays_batch(
            FlatDecoder(scene["dflat"]), _t(planes),
            *(_t(batch[k]) for k in ("rays_o", "rays_d", "near", "far", "box_warp")),
            RenderConfig(**cfg), deform_fn=canonical_deform(
                {k: _t(v) for k, v in batch.items()}, scene["pm"]))
    for k, tol in (("rgb", 2e-5), ("acc", 2e-5), ("depth", 1e-4)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol, err_msg=k)
    assert float(got["acc"].max()) > 0.1  # the deformed points meet density


def _view_item(scene, b=0, S=12):
    """A full-image view of item ``b`` from an orbit camera, with its SMPL arrays."""
    K, R, T = NovelViewCameras(S).camera(5)
    ro, rd, near, far, mask = full_image_rays(S, S, K, R, T, BOX)
    item = {"hw": np.asarray([S, S]), "rays_o": ro, "rays_d": rd, "near": near, "far": far,
            "ray_mask": mask.astype(np.float32), "box_warp": BOX,
            "rgb": np.random.default_rng(9).uniform(size=(S * S, 3)).astype(np.float32)}
    item.update({k: v[b] for k, v in scene["smpl"].items()})
    return item


def _port_decoder(scene):
    dec = NeRFDecoder()
    dec.load_state_dict(FlatDecoder(scene["dflat"]).state_dict())
    return dec


def test_render_image_masked_with_eval_deform_matches_jax(scene):
    item = _view_item(scene)
    cfg = dict(n_samples=8, n_importance=8, perturb=False, density_noise=False)
    args = {k: item[k] for k in KEYS}
    rays = [item[k] for k in ("rays_o", "rays_d", "near", "far", "ray_mask")]
    want = jrender.render_image_masked(
        scene["dec"], scene["dvars"], jnp.asarray(scene["planes"][0, 1]), *rays, BOX,
        jrender.RenderConfig(**cfg), chunk=64, deform_fn=jcan.make_eval_deform_fn(scene["jm"]),
        deform_args=args)
    got = render_image_masked(_port_decoder(scene), _t(scene["planes"][0, 1]), *rays, BOX,
                              RenderConfig(**cfg), chunk=50,
                              deform_fn=canonical.make_eval_deform_fn(scene["pm"]),
                              deform_args=args)
    for k, tol in (("rgb", 2e-5), ("acc", 2e-5), ("depth", 1e-4)):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=tol, err_msg=k)
    assert float(got["acc"].max()) > 0.1


def test_eval_deform_is_the_batched_deform_of_smpl_space(scene):
    """make_eval_deform_fn = world to SMPL space (directions translated by Th
    too, the reference's quirk) + the batched deform at B 1; held to JAX's
    eval deform."""
    item = _view_item(scene, b=1)
    args = {k: item[k] for k in KEYS}
    rng = np.random.default_rng(2)
    pts = rng.normal(scale=0.5, size=(300, 3)).astype(np.float32)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    got = canonical.make_eval_deform_fn(scene["pm"])(_t(pts), _t(dirs), args)
    want = jcan.make_eval_deform_fn(scene["jm"])(jnp.asarray(pts), jnp.asarray(dirs), args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    R, Th = _t(args["R"])[None], _t(args["Th"])[None]
    direct = canonical.deform_to_canonical_batched(
        scene["pm"], *(_t(args[k])[None] for k in ("poses", "betas", "t_poses", "smpl_verts")),
        canonical.world_to_smpl(_t(pts)[None], R, Th),
        canonical.world_to_smpl(_t(dirs)[None], R, Th))
    torch.testing.assert_close(got[1], direct[1][0], rtol=0, atol=0)


def test_evaluate_views_with_deform_matches_jax(scene):
    items = [_view_item(scene, b) for b in (0, 1)]
    cfg = dict(n_samples=8, n_importance=8, perturb=False, density_noise=False)
    dargs = lambda it: {k: it[k] for k in KEYS}  # noqa: E731
    want = jharness.evaluate_views(scene["dec"], scene["dvars"],
                                   jnp.asarray(scene["planes"][1, 1]), items,
                                   jrender.RenderConfig(**cfg), chunk=64,
                                   deform_fn=jcan.make_eval_deform_fn(scene["jm"]),
                                   deform_args_fn=dargs)
    got = evaluate_views(_port_decoder(scene), _t(scene["planes"][1, 1]), items,
                         RenderConfig(**cfg), chunk=64,
                         deform_fn=canonical.make_eval_deform_fn(scene["pm"]),
                         deform_args_fn=dargs)
    assert abs(got["psnr"] - want["psnr"]) <= 0.01 and abs(got["ssim"] - want["ssim"]) <= 1e-4


def test_fast_tier_with_deform_matches_jax(scene):
    """The grid is built without the deform (the planes' own space); the
    coarse phase deforms points, the fine pass points and directions."""
    item = _view_item(scene, S=16)
    args = {k: item[k] for k in KEYS}
    cfg = dict(n_samples=16, n_importance=16, perturb=False, density_noise=False)
    planes = scene["planes"][0, 1]
    rays = [item[k] for k in ("rays_o", "rays_d", "near", "far", "ray_mask")]
    eps = 1e-2
    jgrid = jfp.build_density_grid(scene["dec"], scene["dvars"], jnp.asarray(planes), BOX,
                                   resolution=16)
    want = jfp.render_image_fast(scene["dec"], scene["dvars"], jnp.asarray(planes), jgrid,
                                 *rays, BOX, jrender.RenderConfig(**cfg), chunk=64,
                                 deform_fn=jcan.make_eval_deform_fn(scene["jm"]),
                                 deform_args=args, early_term_eps=eps, coarse_chunk=64)
    dec = _port_decoder(scene)
    grid = fastpath.build_density_grid(dec, _t(planes), BOX, resolution=16)
    deform = canonical.make_eval_deform_fn(scene["pm"])
    got = fastpath.render_image_fast(dec, _t(planes), grid, *rays, BOX, RenderConfig(**cfg),
                                     chunk=50, deform_fn=deform, deform_args=args,
                                     early_term_eps=eps)
    sel = item["ray_mask"].astype(bool)
    _, acc_est = fastpath.coarse_from_grid(
        grid, *(_t(a[sel]) for a in rays[:4]), _t(BOX),
        RenderConfig(**cfg), bind_deform(deform, args))
    assert float((acc_est - eps).abs().min()) > 1e-4  # no ray on the edge
    assert 0 < int((acc_est > eps).sum()) < int(sel.sum())  # some rays terminated
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(got["acc"].numpy() > 0, want["acc"] > 0)


def test_density_grid_with_deform_matches_jax(scene):
    item = _view_item(scene)
    args = {k: item[k] for k in KEYS}
    planes = scene["planes"][1, 0]
    jdeform = jcan.make_eval_deform_fn(scene["jm"])
    want = jgeometry.eval_density_grid(scene["dec"], scene["dvars"], jnp.asarray(planes), BOX,
                                       resolution=8, chunk=128,
                                       deform_fn=lambda p, d: jdeform(p, d, args))
    got = geometry.eval_density_grid(_port_decoder(scene), _t(planes), BOX, resolution=8,
                                     chunk=100, deform_fn=bind_deform(
                                         canonical.make_eval_deform_fn(scene["pm"]), args))
    np.testing.assert_allclose(got, want, atol=1e-4)
    plain = geometry.eval_density_grid(_port_decoder(scene), _t(planes), BOX, resolution=8)
    assert np.abs(plain - got).max() > 1e-2  # the deform moved the lattice


# ---------------- the canonical Stage-1 step ----------------


def _configs():
    return U.configs(use_canonical_space=True)


def test_canonical_loss_and_gradients_match_jax(scene, monkeypatch):
    jcfg, cfg = _configs()
    batch = _ray_batch(scene)
    with U.jax_deterministic(monkeypatch) as fns:
        jp = {"planes": jnp.asarray(scene["planes"]), "decoder": scene["dvars"]}
        (jl, jaux), g = fns.loss_and_grad(jp, U.to_jax(batch), scene["dec"], jcfg,
                                          jax.random.key(0), scene["jm"])
    params = {"planes": _t(scene["planes"].copy()).requires_grad_(True),
              "decoder": scene["dflat"].clone().requires_grad_(True)}
    loss, aux = stage1_loss(params, U.to_torch(batch), cfg, body_model=scene["pm"])
    gp, gd = torch.autograd.grad(loss, [params["planes"], params["decoder"]])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("img_loss", "acc_loss", "tv", "l1", "psnr"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    jgp = np.asarray(g["planes"])
    assert np.linalg.norm(gp.numpy() - jgp) <= 1e-5 * np.linalg.norm(jgp)
    views = FlatDecoder(gd).state_dict()
    jviews = FlatDecoder(torch.from_numpy(U.decoder_flat(g["decoder"]))).state_dict()
    for name in views:
        bar = 1e-4 if name.startswith("alpha_linear") else 1e-5
        assert float((views[name] - jviews[name]).norm()) <= bar * float(jviews[name].norm()), name
    assert float(aux["acc_loss"]) > 1e-3 and gp[0, 1].abs().max() > 0


def test_canonical_train_steps_match_jax(scene, monkeypatch):
    """One step from a common state, then the port's second step from JAX's
    state after the first (scripts/export_jax_weights.py ->
    compat/from_jax.py), each against JAX's."""
    jcfg, cfg = _configs()
    batches = [_ray_batch(scene, seed=0), _ray_batch(scene, seed=1)]
    tx = joptim.make_stage1_optimizer(5e-3, 1e-1, 500)
    jp = {"planes": jnp.asarray(scene["planes"]), "decoder": scene["dvars"]}
    jstate = jstage1.TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=tx.init(jp),
                                tx=tx)
    state = create_train_state({"planes": _t(scene["planes"].copy()),
                                "decoder": scene["dflat"].clone()},
                               optim.make_stage1_optimizer(5e-3, 1e-1, 500))
    with U.jax_deterministic(monkeypatch) as fns:
        for i, b in enumerate(batches):
            if i == 1:
                restore_into(state, stage1_state_from_arrays(
                    export_jax_weights.stage1_state_arrays(jstate)))
            _, g = fns.loss_and_grad(jstate.params, U.to_jax(b), scene["dec"], jcfg,
                                     jax.random.key(1), scene["jm"])
            near = {"planes": np.abs(np.asarray(g["planes"])) < U.NEAR_ZERO_GRAD,
                    "decoder": np.abs(U.decoder_flat(g["decoder"])) < U.NEAR_ZERO_GRAD}
            jstate, jaux = fns.step(jstate, U.to_jax(b), jax.random.key(1), scene["dec"], jcfg,
                                    scene["jm"])
            aux = train_step(state, U.to_torch(b), cfg, body_model=scene["pm"])
            np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
            U.near_zero_rule(state.params["planes"].numpy(), np.asarray(jstate.params["planes"]),
                             0.1, 1, f"planes, step {i + 1}", near["planes"])
            U.near_zero_rule(state.params["decoder"].numpy(),
                             U.decoder_flat(jstate.params["decoder"]), 5e-3, 1,
                             f"decoder, step {i + 1}", near["decoder"])
    assert state.step == int(jstate.step) == 2


def test_canonical_step_moves_only_through_the_planes(scene):
    """No gradient reaches the points: the deform runs without autograd, and
    the canonical step's gradient of the table is finite and nonzero."""
    _, cfg = _configs()
    batch = {k: v.requires_grad_(True) if k in ("rays_o", "rays_d") else v
             for k, v in U.to_torch(_ray_batch(scene)).items()}
    params = {"planes": _t(scene["planes"].copy()).requires_grad_(True),
              "decoder": scene["dflat"].clone()}
    loss, _ = stage1_loss(params, batch, cfg, body_model=scene["pm"])
    g_planes, g_rays = torch.autograd.grad(loss, [params["planes"], batch["rays_o"]],
                                           allow_unused=True)
    assert g_rays is None or float(g_rays.abs().max()) == 0.0
    assert torch.isfinite(g_planes).all() and float(g_planes.abs().max()) > 0


# ---------------- the committed JAX reference ----------------

REFERENCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "runs",
                         "quality", "canonical_jax_reference.npz")


@pytest.fixture(scope="module")
def reference():
    with np.load(REFERENCE) as z:
        ref = {k: z[k] for k in z.files}
    body = smpl.make_synthetic_body_model(24, 6890, 10, 0)
    assert float(body.v_template.astype(np.float64).sum()) == float(ref["v_template_sum"])
    return ref, body


def test_committed_reference_deform(reference):
    """scripts/canonical_jax_reference.py's 4,096 world points: the port's
    eval deform gives JAX's nearest vertex on every point and its canonical
    points and directions within 1e-5 (coordinates up to 7 m)."""
    ref, body = reference
    args = {k: ref[k] for k in KEYS}
    R, Th = _t(ref["R"])[None], _t(ref["Th"]).reshape(1, 1, 3)
    ids = canonical.nearest_vertex_batched(
        canonical.world_to_smpl(_t(ref["query_pts"])[None], R, Th), _t(ref["smpl_verts"])[None])
    np.testing.assert_array_equal(ids[0].numpy(), ref["query_ids"])
    pts, dirs = canonical.make_eval_deform_fn(body)(_t(ref["query_pts"]),
                                                    _t(ref["query_dirs"]), args)
    np.testing.assert_allclose(pts.numpy(), ref["can_pts"], atol=1e-5)
    np.testing.assert_allclose(dirs.numpy(), ref["can_dirs"], atol=1e-5)


def test_committed_reference_render_subset(reference):
    """256 seeded in-box rays of the reference's 128^2 canonical view of the
    fitted planes, rendered by the port on the CPU (plain decoder, 128 + 128
    samples), against the JAX exact tier: rgb and acc within 5e-3 and PSNR
    >= 50 dB. Not the world-space 2e-5: JAX's own ``render_rays`` of these
    256 rays differs from its ``render_image_masked`` of the view (chunks of
    256 others) by up to 1.2e-3 (the port: 1.2e-3), as the deform's last
    bits move a few queries across a bf16 rounding step and so to another
    vertex, and the fine samples placed from the coarse densities follow."""
    from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
    from humanliff_tpu_torch.nerf.renderer import render_rays
    from humanliff_tpu_torch.train.checkpoint import load_decoder_npz

    ref, body = reference
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dec = NeRFDecoder()
    dec.load_state_dict(decoder_state_dict(load_decoder_npz(
        os.path.join(repo, "runs", "quality", "train", "decoder_060000.npz"))))
    with np.load(os.path.join(repo, "runs", "quality", "stage2", "planes",
                              "campaign0000_060000.npz")) as z:
        planes = _t(np.asarray(z["tri_planes"][int(ref["layer"])], np.float32))
    S = int(ref["image_size"])
    ro, rd, near, far, mask = full_image_rays(S, S, ref["K"], ref["R_cam"], ref["T_cam"],
                                              ref["world_bounds"])
    np.testing.assert_array_equal(mask, ref["mask"])
    idx = np.sort(np.random.default_rng(0).choice(np.flatnonzero(mask), 256, replace=False))
    n = int(ref["n_samples"])
    with torch.no_grad():
        out = render_rays(dec, planes, *(_t(a[idx]) for a in (ro, rd, near, far)),
                          _t(ref["box_warp"]), RenderConfig(n_samples=n, n_importance=n,
                                                            perturb=False, density_noise=False),
                          deform_fn=canonical.make_eval_deform_fn(body),
                          deform_args={k: ref[k] for k in KEYS})
    for k in ("rgb", "acc"):
        np.testing.assert_allclose(out[k].numpy(), ref[k][idx], atol=5e-3, err_msg=k)
        mse = float(np.mean((out[k].numpy().astype(np.float64) - ref[k][idx]) ** 2))
        assert 10 * np.log10(1.0 / max(mse, 1e-30)) >= 50.0, (k, mse)
    assert 0.2 < float((out["acc"] > 0.5).float().mean()) < 0.95
