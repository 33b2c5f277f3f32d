"""Port parity of the exact renderer against the JAX package, on the CPU:
``render_rays`` and ``render_image_masked`` (coarse density-only pass,
importance sampling, fine pass, compositing, depth normalisation), with the
decoder carried over by ``compat/from_jax.py``.

Bar: PSNR >= 45 dB on rgb, acc and depth, the bar of
tests/test_render_parity_e2e.py, for fp32 planes and for bf16 planes (both
packages round the sampled features to bf16 and decode them in fp32).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_port_util import psnr
from humanliff_tpu.data.raygen import full_image_rays as jax_full_image_rays
from humanliff_tpu.data.view_datasets import NovelViewCameras as JaxCameras
from humanliff_tpu.nerf.decoder import NeRFDecoder as JaxDecoder
from humanliff_tpu.nerf import renderer as jrender
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.data.raygen import full_image_rays
from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder
from humanliff_tpu_torch.nerf import renderer

BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)
CFG = dict(n_samples=16, n_importance=16, perturb=False, density_noise=False)


def _scene(seed=0, D=24):
    """Planes with a soft ellipsoid density (a surface to find) plus noise."""
    rng = np.random.default_rng(seed)
    g = (np.arange(D) + 0.5) / D * 2 - 1
    u, v = np.meshgrid(g, g, indexing="xy")
    blob = np.exp(-3.0 * (u**2 + v**2))
    planes = 0.5 * rng.normal(size=(3, 9, D, D)) + 2.0 * blob[None, None]
    dec = JaxDecoder()
    params = jax.device_get(dec.init(jax.random.key(seed), jnp.zeros((1, 27)),
                                     jnp.zeros((1, 3))))
    port = NeRFDecoder()
    port.load_state_dict(decoder_state_dict(params))
    return planes.astype(np.float32), dec, params, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_rays(dtype):
    planes, dec, params, port = _scene()
    K, R, T = JaxCameras(40).camera(3)
    ro, rd, near, far, mask = jax_full_image_rays(40, 40, K, R, T, BOUNDS)
    sel = np.flatnonzero(mask)[::3]
    ro, rd, near, far = ro[sel], rd[sel], near[sel], far[sel]
    cfg = jrender.RenderConfig(**CFG)
    ref = jrender.render_rays(
        dec, params, jnp.asarray(planes).astype(getattr(jnp, dtype)), jnp.asarray(ro),
        jnp.asarray(rd), jnp.asarray(near), jnp.asarray(far), jnp.asarray(BOUNDS), cfg)
    with torch.no_grad():
        out = renderer.render_rays(
            port, torch.from_numpy(planes).to(getattr(torch, dtype)),
            torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(near),
            torch.from_numpy(far), torch.from_numpy(BOUNDS), renderer.RenderConfig(**CFG))
    assert float(np.asarray(ref["rgb"]).std()) > 0.01  # the scene is not uniform
    for k in ("rgb", "acc", "depth"):
        assert out[k].shape == ref[k].shape
        assert psnr(out[k].numpy(), ref[k]) >= 45.0, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_image_masked(dtype):
    """A 32^2 orbit view in ragged chunks of 100 rays (the JAX side pads to
    its chunk); off-box pixels must match too."""
    planes, dec, params, port = _scene(seed=1)
    S = 32
    K, R, T = NovelViewCameras(S).camera(5)
    ro, rd, near, far, mask = full_image_rays(S, S, K, R, T, BOUNDS)
    # An off-box border: mask out the outer ring so the compaction is exercised.
    ring = np.zeros((S, S), bool)
    ring[4:-4, 4:-4] = True
    mask = mask & ring.reshape(-1)
    ref = jrender.render_image_masked(
        dec, params, jnp.asarray(planes).astype(getattr(jnp, dtype)), ro, rd, near, far,
        mask, jnp.asarray(BOUNDS), jrender.RenderConfig(**CFG), chunk=128, bg_color=0.25)
    out = renderer.render_image_masked(
        port, torch.from_numpy(planes).to(getattr(torch, dtype)), ro, rd, near, far, mask,
        BOUNDS, renderer.RenderConfig(**CFG), chunk=100, bg_color=0.25)
    for k in ("rgb", "acc", "depth"):
        assert psnr(out[k].numpy(), ref[k]) >= 45.0, k
    np.testing.assert_array_equal(out["rgb"].numpy()[~mask], 0.25)
    np.testing.assert_array_equal(out["acc"].numpy()[~mask], 0.0)


def test_render_config_matches():
    ours = {f.name: f.default for f in dataclasses.fields(renderer.RenderConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jrender.RenderConfig)}
    assert ours == theirs


def test_render_rays_training_randomness_is_seeded():
    """Jitter, random fine samples and density noise come from the generator:
    one seed renders the same twice, and differs from the eval render. (JAX
    draws from its own keys, so this path has no cross-package parity.)"""
    planes, _, _, port = _scene(seed=2)
    K, R, T = NovelViewCameras(24).camera(1)
    ro, rd, near, far, mask = full_image_rays(24, 24, K, R, T, BOUNDS)
    args = [torch.from_numpy(a[mask]) for a in (ro, rd, near, far)]
    cfg = renderer.RenderConfig(n_samples=16, n_importance=16)

    def render(gen):
        with torch.no_grad():
            return renderer.render_rays(port, torch.from_numpy(planes), *args,
                                        torch.from_numpy(BOUNDS), cfg, generator=gen)

    a = render(torch.Generator().manual_seed(5))
    b = render(torch.Generator().manual_seed(5))
    ev = render(None)
    for k in ("rgb", "acc", "depth"):
        assert torch.isfinite(a[k]).all()
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert float((a["rgb"] - ev["rgb"]).abs().max()) > 1e-3
