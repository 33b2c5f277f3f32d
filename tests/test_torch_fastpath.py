"""Port parity of the fast decode tier (``nerf/fastpath.py``) against the JAX
package, on the CPU, and ``tests/test_fastpath.py``'s properties on the port.

Bars:
- grid tables: fp32 rtol/atol 2e-4 (tests/test_fastpath.py:42; the lattice
  comes from ``torch.linspace`` vs ``jnp.linspace``); bf16 rtol 2**-7, atol
  2e-4: features summed in another order may round to the neighbouring bf16
  value (one ulp is 2**-8 relative).
- lookup on the same table: fp32 atol 1e-6; bf16 atol 1e-2 (the weights and
  the sum are bf16, as in JAX).
- ``render_image_fast``: the same terminated rays, and rgb, acc and depth
  within atol 1e-3. The scene is picked so that no ray's grid-estimated
  accumulated alpha lies within 1e-4 of ``early_term_eps``, which the test
  asserts: otherwise one ray flipping decides it.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from humanliff_tpu.nerf import fastpath as jfp
from humanliff_tpu.nerf.decoder import NeRFDecoder as JaxDecoder
from humanliff_tpu.nerf.renderer import RenderConfig as JaxConfig
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.data.raygen import full_image_rays
from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
from humanliff_tpu_torch.nerf import fastpath
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder
from humanliff_tpu_torch.nerf.renderer import RenderConfig, render_image_masked

BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)
CFG = dict(n_samples=16, n_importance=16, perturb=False, density_noise=False)
EPS = 1.5e-2


def _scene(seed=1, alpha_shift=3.5, D=24):
    """Planes with a soft blob plus noise; the alpha head's bias lowered by
    ``alpha_shift`` so that some rays are empty."""
    rng = np.random.default_rng(seed)
    g = (np.arange(D) + 0.5) / D * 2 - 1
    u, v = np.meshgrid(g, g, indexing="xy")
    blob = np.exp(-3.0 * (u**2 + v**2))
    planes = (0.5 * rng.normal(size=(3, 9, D, D)) + 2.0 * blob[None, None]).astype(np.float32)
    dec = JaxDecoder()
    params = jax.device_get(dec.init(jax.random.key(seed), jnp.zeros((1, 27)),
                                     jnp.zeros((1, 3))))
    params["params"]["alpha"]["bias"] = params["params"]["alpha"]["bias"] - alpha_shift
    port = NeRFDecoder()
    port.load_state_dict(decoder_state_dict(params))
    return planes, dec, params, port


def _view(S=32, view=3):
    K, R, T = NovelViewCameras(S).camera(view)
    return full_image_rays(S, S, K, R, T, BOUNDS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_density_grid_matches_jax(dtype):
    planes, dec, params, port = _scene()
    ref = jfp.build_density_grid(dec, params, jnp.asarray(planes).astype(getattr(jnp, dtype)),
                                 BOUNDS, resolution=16)
    out = fastpath.build_density_grid(port, torch.from_numpy(planes).to(getattr(torch, dtype)),
                                      BOUNDS, resolution=16, build_chunk=1000)
    assert out.resolution == ref.resolution == 16
    assert out.table.dtype == getattr(torch, dtype) and tuple(out.table.shape) == (17**3, 8)
    a = np.asarray(ref.table.astype(jnp.float32))
    rtol = 2e-4 if dtype == "float32" else 2**-7
    np.testing.assert_allclose(out.table.float().numpy(), a, rtol=rtol, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_grid_density_matches_jax(dtype):
    """Both lookups on one table (the JAX one), at random points in and
    beyond the box (clamped to the edge cells)."""
    planes, dec, params, _ = _scene()
    ref_grid = jfp.build_density_grid(
        dec, params, jnp.asarray(planes).astype(getattr(jnp, dtype)), BOUNDS, resolution=16)
    table = torch.tensor(np.asarray(ref_grid.table.astype(jnp.float32))).to(
        getattr(torch, dtype))
    grid = fastpath.DensityGrid(table=table, resolution=16)
    pts = np.random.default_rng(3).uniform(-1.3, 1.3, size=(4000, 3)).astype(np.float32)
    ref = np.asarray(jfp.sample_grid_density(ref_grid, jnp.asarray(pts), jnp.asarray(BOUNDS)))
    out = fastpath.sample_grid_density(grid, torch.from_numpy(pts), torch.from_numpy(BOUNDS))
    assert out.dtype == torch.float32 and out.shape == (4000,)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6 if dtype == "float32" else 1e-2)


def test_grid_exact_at_lattice_points():
    """At lattice nodes the trilinear lookup is the decoder's own density."""
    planes, _, _, port = _scene()
    pl, box = torch.from_numpy(planes), torch.from_numpy(BOUNDS)
    grid = fastpath.build_density_grid(port, pl, BOUNDS, resolution=8)
    lin = [np.linspace(BOUNDS[0, d], BOUNDS[1, d], 9, dtype=np.float32) for d in range(3)]
    pts = torch.from_numpy(np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)[::7])
    from humanliff_tpu_torch.ops.triplane import sample_triplane_features

    want = port(sample_triplane_features(pl, pts, box))[1][:, 0]
    got = fastpath.sample_grid_density(grid, pts, box)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_image_fast_matches_jax(dtype):
    planes, dec, params, port = _scene()
    ro, rd, near, far, mask = _view()
    jplanes = jnp.asarray(planes).astype(getattr(jnp, dtype))
    pl = torch.from_numpy(planes).to(getattr(torch, dtype))
    jgrid = jfp.build_density_grid(dec, params, jplanes, BOUNDS, resolution=16)
    grid = fastpath.build_density_grid(port, pl, BOUNDS, resolution=16)
    cfg = RenderConfig(**CFG)
    _, acc_est = fastpath.coarse_from_grid(
        grid, *(torch.from_numpy(a[mask]) for a in (ro, rd, near, far)),
        torch.from_numpy(BOUNDS), cfg)
    assert float((acc_est - EPS).abs().min()) >= 1e-4  # no ray near the cut
    kept = int((acc_est > EPS).sum())
    assert 0 < kept < int(mask.sum())  # some rays terminate, some do not

    ref = jfp.render_image_fast(dec, params, jplanes, jgrid, ro, rd, near, far, mask, BOUNDS,
                                JaxConfig(**CFG), chunk=64, early_term_eps=EPS,
                                bg_color=0.25)
    out = fastpath.render_image_fast(port, pl, grid, ro, rd, near, far, mask, BOUNDS, cfg,
                                     chunk=100, early_term_eps=EPS, bg_color=0.25)
    terminated = mask & (out["acc"].numpy() == 0)
    np.testing.assert_array_equal(terminated, mask & (np.asarray(ref["acc"]) == 0))
    assert int(terminated.sum()) == int(mask.sum()) - kept
    for k in ("rgb", "acc", "depth"):
        assert out[k].dtype == torch.float32 and out[k].shape == ref[k].shape
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(out["rgb"].numpy()[~mask], 0.25)


def test_grid_cache_rebuilds_only_on_box_change():
    planes, _, _, port = _scene()
    cache = fastpath.GridCache(port, torch.from_numpy(planes), resolution=8)
    g1 = cache.get(BOUNDS)
    assert cache.get(BOUNDS.copy()) is g1
    g3 = cache.get(BOUNDS * 1.5)
    assert g3 is not g1 and g3.table.shape == g1.table.shape
    assert cache.get(BOUNDS * 1.5) is g3


def test_fast_render_close_to_exact():
    """With every ray kept, only the fine samples' placement differs from the
    exact renderer (tests/test_fastpath.py:43-62's bounds)."""
    planes, _, _, port = _scene(alpha_shift=0.0)
    ro, rd, near, far, mask = _view()
    pl = torch.from_numpy(planes)
    cfg = RenderConfig(n_samples=32, n_importance=32, perturb=False, density_noise=False)
    exact = render_image_masked(port, pl, ro, rd, near, far, mask, BOUNDS, cfg, chunk=128)
    grid = fastpath.build_density_grid(port, pl, BOUNDS, resolution=48)
    fast = fastpath.render_image_fast(port, pl, grid, ro, rd, near, far, mask, BOUNDS, cfg,
                                      chunk=128, early_term_eps=-1.0)
    d = (fast["rgb"] - exact["rgb"]).abs()
    assert float(d[torch.from_numpy(mask)].mean()) < 0.02
    np.testing.assert_allclose(fast["acc"].numpy(), exact["acc"].numpy(), atol=0.05)


def test_fast_render_terminates_empty_rays():
    planes, _, _, port = _scene(alpha_shift=100.0)  # zero density everywhere
    ro, rd, near, far, mask = _view()
    pl = torch.from_numpy(planes)
    grid = fastpath.build_density_grid(port, pl, BOUNDS, resolution=16)
    out = fastpath.render_image_fast(port, pl, grid, ro, rd, near, far, mask, BOUNDS,
                                     RenderConfig(**CFG), chunk=64, early_term_eps=1e-2,
                                     bg_color=0.5)
    np.testing.assert_array_equal(out["rgb"].numpy(), 0.5)
    np.testing.assert_array_equal(out["acc"].numpy(), 0.0)


def test_fast_render_respects_ray_mask():
    planes, _, _, port = _scene()
    ro, rd, near, far, mask = _view()
    mask = mask & (np.random.default_rng(1).uniform(size=mask.shape) < 0.5)
    pl = torch.from_numpy(planes)
    grid = fastpath.build_density_grid(port, pl, BOUNDS, resolution=16)
    out = fastpath.render_image_fast(port, pl, grid, ro, rd, near, far, mask, BOUNDS,
                                     RenderConfig(**CFG), chunk=64, early_term_eps=-1.0,
                                     bg_color=0.25)
    np.testing.assert_array_equal(out["rgb"].numpy()[~mask], 0.25)
    np.testing.assert_array_equal(out["acc"].numpy()[~mask], 0.0)
    assert np.any(out["rgb"].numpy()[mask] != 0.25)


@pytest.mark.parametrize("tiling", [dict(coarse_chunk=64), dict(max_rays_in_flight=96)])
def test_fast_render_tiling_does_not_change_the_result(tiling):
    """Big coarse tiles, and ray groups smaller than the image, give the
    all-small-tile render (tests/test_fastpath.py:95-117's 1e-5 / 1e-6)."""
    planes, _, _, port = _scene()
    ro, rd, near, far, mask = _view()
    pl = torch.from_numpy(planes)
    grid = fastpath.build_density_grid(port, pl, BOUNDS, resolution=16)
    args = (port, pl, grid, ro, rd, near, far, mask, BOUNDS, RenderConfig(**CFG))
    small = fastpath.render_image_fast(*args, chunk=16, coarse_chunk=16, early_term_eps=EPS)
    other = fastpath.render_image_fast(*args, chunk=16, early_term_eps=EPS, **tiling)
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(other[k].numpy(), small[k].numpy(), rtol=1e-5, atol=1e-6)
