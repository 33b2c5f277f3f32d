"""Port parity of the render ops against the JAX package, on the CPU:
positional encoding, rays and the AABB test, orbit cameras, the nine-plane
tri-plane sampler, sample_pdf / upsample / merge, and compositing.

Tolerance: fp32, atol 1e-5 (the ops are the same arithmetic in another
library; the JAX sampler interpolates from quad-packed tables and sample_pdf
uses a telescoped prefix sum, which round differently in the last bits).
Host-side numpy ray code is held to exact equality.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_port_util import randomize_tree  # noqa: F401  (sets torch threads)
from humanliff_tpu.data.raygen import full_image_rays as jax_full_image_rays
from humanliff_tpu.data.view_datasets import NovelViewCameras as JaxCameras
from humanliff_tpu.ops import compositing as jcomp
from humanliff_tpu.ops import posenc as jposenc
from humanliff_tpu.ops import sampling as jsamp
from humanliff_tpu.ops import triplane as jtri
from humanliff_tpu_torch.data.raygen import full_image_rays
from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
from humanliff_tpu_torch.ops import compositing, posenc, sampling, triplane

ATOL = 1e-5
BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32), atol=atol)


def test_positional_encoding():
    x = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    for include in (True, False):
        _close(posenc.positional_encoding(torch.from_numpy(x), 4, include),
               jposenc.positional_encoding(jnp.asarray(x), 4, include))


@pytest.mark.parametrize("view", [0, 7, 23])
def test_orbit_camera_rays_exact(view):
    S = 48
    K, R, T = NovelViewCameras(S).camera(view)
    for a, b in zip((K, R, T), JaxCameras(S).camera(view)):
        np.testing.assert_array_equal(a, b)
    ours = full_image_rays(S, S, K, R, T, BOUNDS)
    ref = jax_full_image_rays(S, S, K, R, T, BOUNDS)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert ours[4].sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_triplane_sampler_single(dtype):
    """World points inside and outside the box (zeros padding), D=16; bf16
    planes are read as fp32 (the JAX lerp promotes them too)."""
    rng = np.random.default_rng(1)
    planes = rng.normal(size=(3, 9, 16, 16)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, size=(500, 3)).astype(np.float32)
    jp = jnp.asarray(planes).astype(getattr(jnp, dtype))
    tp = torch.from_numpy(planes).to(getattr(torch, dtype))
    ref = jtri.sample_triplane_features(jp, jnp.asarray(coords), jnp.asarray(BOUNDS))
    out = triplane.sample_triplane_features(tp, torch.from_numpy(coords),
                                            torch.from_numpy(BOUNDS))
    assert out.shape == (500, 27) and out.dtype == torch.float32 and out.is_contiguous()
    _close(out, ref)


def test_triplane_sampler_batched_normalized():
    rng = np.random.default_rng(2)
    planes = rng.normal(size=(2, 3, 9, 8, 8)).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, size=(2, 100, 3)).astype(np.float32)
    ref = jtri.sample_triplane_features(jnp.asarray(planes), jnp.asarray(coords))
    out = triplane.sample_triplane_features(torch.from_numpy(planes),
                                            torch.from_numpy(coords))
    _close(out, ref)


def test_stratified_z_vals_deterministic():
    rng = np.random.default_rng(3)
    near = rng.uniform(1, 2, size=(20,)).astype(np.float32)
    far = near + rng.uniform(0.5, 2, size=(20,)).astype(np.float32)
    _close(sampling.stratified_z_vals(torch.from_numpy(near), torch.from_numpy(far), 16),
           jsamp.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 16))


@pytest.mark.parametrize("case", ["random", "peaked", "flat"])
def test_sample_pdf(case):
    """Deterministic u. 'peaked' puts all weight on one bin, 'flat' has all
    weights zero: the denom < 1e-5 guard and the tie of u = 0 with cdf[0] = 0
    are hit.

    u = 1 meets cdf[-1] = 1 +- a few ulp, and the two libraries round the
    fp32 normalisation and prefix sum to different sides of 1 (XLA above,
    torch's CPU cumsum below). Where the last bin's mass is under the 1e-5
    guard ('peaked') that sample then lands on the last bin's upper or lower
    edge. So the u = 1 column is held to lie in the last bin in both packages,
    and every other sample to atol 4e-5 (1e-5 of the depth range 4)."""
    rng = np.random.default_rng(4)
    R, B = 32, 64
    bins = np.sort(rng.uniform(0, 4, size=(R, B)), axis=-1).astype(np.float32)
    if case == "random":
        w = rng.uniform(0, 1, size=(R, B - 1)).astype(np.float32)
    elif case == "peaked":
        w = np.zeros((R, B - 1), np.float32)
        w[np.arange(R), rng.integers(0, B - 1, size=R)] = 5.0
    else:
        w = np.zeros((R, B - 1), np.float32)
    ref = np.asarray(jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 48))
    out = sampling.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 48).numpy()
    np.testing.assert_allclose(out[:, :-1], ref[:, :-1], atol=4e-5)
    for last in (out[:, -1], ref[:, -1]):
        assert np.all(last >= bins[:, -2] - 4e-5) and np.all(last <= bins[:, -1] + 4e-5)
    if case == "random":
        np.testing.assert_allclose(out[:, -1], ref[:, -1], atol=4e-5)


def test_upsample_and_merge():
    rng = np.random.default_rng(5)
    R, S = 16, 32
    z = np.sort(rng.uniform(1, 3, size=(R, S)), axis=-1).astype(np.float32)
    dens = rng.normal(scale=3, size=(R, S)).astype(np.float32)
    rays_d = rng.normal(size=(R, 3)).astype(np.float32)
    ref = jsamp.upsample_z_vals(jnp.asarray(dens), jnp.asarray(z), jnp.asarray(rays_d), 24)
    out = sampling.upsample_z_vals(torch.from_numpy(dens), torch.from_numpy(z),
                                   torch.from_numpy(rays_d), 24)
    # A cdf rounding of ~1e-7 is divided by a bin's mass (down to the 1e-5
    # guard) in the inverse-CDF lerp: 1e-4 at these bin widths.
    _close(out, ref, atol=1e-4)
    _close(sampling.merge_z_vals(torch.from_numpy(z), out),
           jsamp.merge_z_vals(jnp.asarray(z), jnp.asarray(out.numpy())), atol=0)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_compositing(white_bkgd):
    rng = np.random.default_rng(6)
    R, S = 24, 40
    rgb = rng.uniform(size=(R, S, 3)).astype(np.float32)
    dens = rng.normal(scale=4, size=(R, S)).astype(np.float32)
    z = np.sort(rng.uniform(0, 2, size=(R, S)), axis=-1).astype(np.float32)
    ref = jcomp.composite_rays(jnp.asarray(rgb), jnp.asarray(dens), jnp.asarray(z),
                               white_bkgd=white_bkgd)
    out = compositing.composite_rays(torch.from_numpy(rgb), torch.from_numpy(dens),
                                     torch.from_numpy(z), white_bkgd=white_bkgd)
    for a, b in zip(out, ref):
        _close(a, b)
    _close(compositing.volume_weights(torch.from_numpy(dens), torch.from_numpy(z)),
           jcomp.volume_weights(jnp.asarray(dens), jnp.asarray(z)))
