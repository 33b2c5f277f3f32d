"""Port parity of mesh extraction (``nerf/geometry.py``, ``mesh/``) against the
JAX package, on the CPU.

- ``eval_density_grid``: atol 1e-4 against the JAX grid (fp32 features, the
  decoder's sums in another order).
- ``extract_mesh`` at 16^3: the same vertex and triangle counts, the same
  triangles, vertices within 1e-5 (no smoothed grid value lies within 5e-4
  of the iso level, which the test asserts).
- Marching cubes and smoothing: the port's library, built from
  ``native/marching_cubes.cpp``, gives the JAX binding's output bit for bit;
  the sphere properties of tests/test_mesh.py hold; PLY files match the JAX
  writer byte for byte.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from humanliff_tpu.mesh import io as jio
from humanliff_tpu.mesh import marching_cubes as jax_marching_cubes, smooth_grid as jax_smooth
from humanliff_tpu.nerf import geometry as jgeometry
from humanliff_tpu.nerf.decoder import NeRFDecoder as JaxDecoder
from humanliff_tpu_torch import kernels
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.mesh import io, marching_cubes as mc
from humanliff_tpu_torch.nerf import geometry
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder

BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)


def _scene(seed=2, D=24, alpha_shift=0.8457):
    """A soft blob in every plane through a decoder whose density crosses 0
    inside the box: ``alpha_shift`` puts the iso level in a gap between the
    smoothed grid's values at 16^3."""
    rng = np.random.default_rng(seed)
    g = (np.arange(D) + 0.5) / D * 2 - 1
    u, v = np.meshgrid(g, g, indexing="xy")
    blob = np.exp(-3.0 * (u**2 + v**2))
    planes = (0.3 * rng.normal(size=(3, 9, D, D)) + 2.0 * blob[None, None]).astype(np.float32)
    dec = JaxDecoder()
    params = jax.device_get(dec.init(jax.random.key(seed), jnp.zeros((1, 27)),
                                     jnp.zeros((1, 3))))
    params["params"]["alpha"]["bias"] = params["params"]["alpha"]["bias"] + alpha_shift
    port = NeRFDecoder()
    port.load_state_dict(decoder_state_dict(params))
    return planes, dec, params, port


def _sphere_grid(n=48, r=0.6):
    lin = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.sqrt(x**2 + y**2 + z**2) - r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_density_grid_matches_jax(dtype):
    planes, dec, params, port = _scene()
    ref = jgeometry.eval_density_grid(dec, params, jnp.asarray(planes).astype(getattr(jnp, dtype)),
                                      BOUNDS, resolution=12, chunk=512)
    out = geometry.eval_density_grid(port, torch.from_numpy(planes).to(getattr(torch, dtype)),
                                     BOUNDS, resolution=12, chunk=1000)
    assert out.dtype == np.float32 and out.shape == (12, 12, 12)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_extract_mesh_matches_jax():
    planes, dec, params, port = _scene()
    grid = geometry.eval_density_grid(port, torch.from_numpy(planes), BOUNDS, resolution=16)
    assert np.abs(mc.smooth_grid(-grid)).min() > 5e-4  # no value near the iso level
    ref_v, ref_t = jgeometry.extract_mesh(dec, params, jnp.asarray(planes), BOUNDS, resolution=16)
    v, t = geometry.extract_mesh(port, torch.from_numpy(planes), BOUNDS, resolution=16)
    assert len(t) > 50 and v.shape == ref_v.shape and t.shape == ref_t.shape
    np.testing.assert_array_equal(t, ref_t)
    np.testing.assert_allclose(v, ref_v, atol=1e-5)
    assert (v >= BOUNDS[0] - 1e-6).all() and (v <= BOUNDS[1] + 1e-6).all()


def test_library_is_built_from_the_source():
    mc._library()
    path = kernels.BUILD_LOG[mc.NAME]["path"]
    assert os.path.dirname(path) == kernels.BUILD_DIR
    assert os.path.basename(path).startswith("libhlmc-")


@pytest.mark.parametrize("case", ["sphere", "noisy"])
def test_marching_cubes_and_smoothing_match_the_jax_binding(case):
    grid = _sphere_grid(24)
    if case == "noisy":
        grid = grid + np.random.default_rng(0).normal(scale=0.05, size=grid.shape).astype(
            np.float32)
    np.testing.assert_array_equal(mc.smooth_grid(grid, 2), jax_smooth(grid, 2))
    v, t = mc.marching_cubes(grid, iso=0.0)
    rv, rt = jax_marching_cubes(grid, iso=0.0)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(t, rt)


def test_sphere_extraction_radius_and_watertightness():
    verts, tris = mc.marching_cubes(_sphere_grid(), iso=0.0)
    assert verts.dtype == np.float32 and tris.dtype == np.int32
    world = verts / (48 - 1) * 2 - 1
    radii = np.linalg.norm(world, axis=1)
    np.testing.assert_allclose(radii.mean(), 0.6, atol=0.02)
    assert radii.std() < 0.02
    edges = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()


def test_empty_surface():
    verts, tris = mc.marching_cubes(np.ones((6, 6, 6), np.float32), iso=0.0)
    assert verts.shape == (0, 3) and tris.shape == (0, 3)


def test_smoothing_reduces_noise():
    rng = np.random.default_rng(0)
    grid = _sphere_grid() + rng.normal(scale=0.05, size=(48, 48, 48)).astype(np.float32)
    sm = mc.smooth_grid(grid, iters=2)
    assert sm.shape == grid.shape

    def hf(g):
        return np.abs(np.diff(g, axis=0)).mean()

    assert hf(sm) < hf(grid) * 0.7


def test_ply_matches_the_jax_writer_and_round_trips(tmp_path):
    verts, tris = mc.marching_cubes(_sphere_grid(24), iso=0.0)
    ours, theirs = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    io.write_ply(ours, verts, tris)
    jio.write_ply(theirs, verts, tris)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    v2, t2 = io.read_ply(ours)
    np.testing.assert_array_equal(v2, verts)
    np.testing.assert_array_equal(t2, tris)
    io.write_obj(str(tmp_path / "a.obj"), verts, tris)
    jio.write_obj(str(tmp_path / "b.obj"), verts, tris)
    with open(tmp_path / "a.obj") as a, open(tmp_path / "b.obj") as b:
        assert a.read() == b.read()
