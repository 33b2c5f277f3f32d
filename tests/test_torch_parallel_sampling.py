"""Port ``sampling/parallel.py`` (sliding-window Picard sampling) against the
JAX module and against the port's own sequential chain, on the CPU at a tiny
ControlNet UNet (6 channels, 16 wide, 8 x 8, 2 heads, no attention; the JAX
module's own test model) with seeded random weights (numpy, seed 0) and the
respaced 8-step schedule.

- One ``_window_step`` (window 4, batch 2) against JAX's, with the noise JAX
  draws from ``fold_in(key, t)`` injected into the port: ``cand`` within
  atol 1e-5, ``resid`` within rtol 1e-4 (fp32 UNet; sums in another order).
- ``_slide`` against JAX's: equal.
- At tol 0 the loop takes one step per model call and equals the port's
  sequential chain (``p_sample_loop``) under the same ``StepNoise``, within
  atol 1e-5 (the batched UNet call sums in another order than batch 2's);
  through ``generate_layer(parallel_window=...)`` too.
- ``TimestepNoise`` is a function of (seed, t) alone.
- ``use_ddim`` with a window raises, as in JAX.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_port_util import random_variables
from humanliff_tpu.diffusion.respace import create_diffusion as jax_create_diffusion
from humanliff_tpu.models.unet import UNetModel as JaxUNet
from humanliff_tpu.sampling import parallel as jax_parallel
from humanliff_tpu_torch.compat.from_jax import unet_state_dict
from humanliff_tpu_torch.diffusion.respace import create_diffusion
from humanliff_tpu_torch.models.unet import UNetModel
from humanliff_tpu_torch.sampling import parallel
from humanliff_tpu_torch.sampling.layered import _model_fn, generate_layer

UNET = dict(in_channels=6, model_channels=16, out_channels=6, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1, 2), num_classes=4, num_heads=2,
            cond_type="controlnet")
SHAPE = (2, 8, 8, 6)


def _jax_setup(respacing="8"):
    model = JaxUNet(**UNET)
    diffusion = jax_create_diffusion(steps=100, timestep_respacing=respacing)
    object.__setattr__(diffusion, "channel_axis", -1)
    x0 = jnp.zeros((1, 8, 8, 6))
    params = random_variables(model, 0, x0, jnp.zeros((1,)), x0, jnp.zeros((1,), jnp.int32))
    return model, diffusion, params


def _port(params=None, respacing="8"):
    if params is None:
        params = _jax_setup(respacing)[2]
    model = UNetModel(**UNET).eval()
    model.load_state_dict(unet_state_dict(params, num_res_blocks=1, channel_mult=(1, 2),
                                          attention_ds=()), strict=True)
    return model, create_diffusion(steps=100, timestep_respacing=respacing)


def test_window_step_matches_jax():
    jmodel, jdiff, params = _jax_setup()
    model, diffusion = _port(params)
    rng = np.random.default_rng(1)
    W, t0 = 4, 5
    X = rng.normal(size=(W,) + SHAPE).astype(np.float32)
    xc = rng.normal(size=SHAPE).astype(np.float32)
    y = np.asarray([1, 2], np.int32)
    key = jax.random.key(7)
    cand_ref, resid_ref = jax_parallel._window_step(
        jdiff, jmodel, params, jnp.asarray(X), jnp.int32(t0), jnp.asarray(xc), jnp.asarray(y),
        key, W, True, True)
    # The noise JAX drew for each timestep of the window.
    noise = {t: np.asarray(jax.random.normal(jax.random.fold_in(key, t), SHAPE, jnp.float32))
             for t in range(t0 - W + 1, t0 + 1)}
    with torch.no_grad():
        cand, resid = parallel._window_step(
            diffusion, _model_fn(model, False), torch.from_numpy(X), t0, torch.from_numpy(xc),
            torch.from_numpy(y).long(), lambda t: torch.from_numpy(noise[t].copy()), True)
    np.testing.assert_allclose(cand.numpy(), np.asarray(cand_ref), atol=1e-5)
    assert resid.shape == (W - 1,)
    np.testing.assert_allclose(resid.numpy(), np.asarray(resid_ref), rtol=1e-4)


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_slide_matches_jax(k):
    W = 6
    cand = np.arange(W * 3, dtype=np.float32).reshape(W, 3)
    ref = np.asarray(jax_parallel._slide(jnp.asarray(cand), jnp.int32(k), W))
    np.testing.assert_array_equal(parallel._slide(torch.from_numpy(cand), k).numpy(), ref)


def _noise(T, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(SHAPE, generator=g), parallel.TimestepNoise(seed, SHAPE, T, "cpu")


@pytest.mark.parametrize("window", [1, 4, 16])
def test_tol_zero_equals_the_sequential_chain(window):
    model, diffusion = _port()
    T = diffusion.num_timesteps
    x_T, step_noise = _noise(T)
    y = torch.tensor([1, 2])
    xc = torch.from_numpy(np.random.default_rng(2).normal(size=SHAPE).astype(np.float32))
    fn = _model_fn(model, False)
    want = diffusion.p_sample_loop(fn, SHAPE, x_cond=xc, noise=x_T, step_noise=step_noise,
                                   model_kwargs={"y": y}, device="cpu")
    got, iters = parallel.parallel_p_sample_loop(diffusion, fn, SHAPE, x_cond=xc, y=y,
                                                 window=window, tol=0.0, noise=x_T,
                                                 step_noise=step_noise, device="cpu")
    assert iters == T  # tol 0 accepts only the exact head: one step per model call
    assert got.shape == SHAPE and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_generate_layer_window_equals_the_sequential_layer():
    model, diffusion = _port()
    x_T, step_noise = _noise(diffusion.num_timesteps, seed=4)
    kw = dict(batch_size=2, image_size=8, channels=6, noise=x_T, step_noise=step_noise,
              device="cpu")
    want = generate_layer(model, diffusion, 2, None, **kw)
    got = generate_layer(model, diffusion, 2, None, parallel_window=4, parallel_tol=0.0, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    # Drawn from a generator: x_T, then the seed of the per-timestep noise.
    a = generate_layer(model, diffusion, 0, None, torch.Generator().manual_seed(5), 2, 8, 6,
                       device="cpu", parallel_window=4, parallel_tol=1e-2)
    b = generate_layer(model, diffusion, 0, None, torch.Generator().manual_seed(5), 2, 8, 6,
                       device="cpu", parallel_window=4, parallel_tol=1e-2)
    assert torch.equal(a, b) and torch.isfinite(a).all() and a.abs().max() <= 1.0 + 1e-6


def test_timestep_noise_is_a_function_of_seed_and_t():
    noise = parallel.TimestepNoise(11, (2, 3), 10, "cpu")
    assert torch.equal(noise(0), noise.at(9)) and torch.equal(noise(9), noise.at(0))
    assert torch.equal(parallel.TimestepNoise(11, (2, 3), 20, "cpu").at(4), noise.at(4))
    assert not torch.equal(noise.at(4), noise.at(5))
    assert not torch.equal(noise.at(4), parallel.TimestepNoise(12, (2, 3), 10, "cpu").at(4))


def test_window_with_ddim_raises():
    model, diffusion = _port()
    with pytest.raises(ValueError, match="use_ddim"):
        generate_layer(model, diffusion, 0, None, batch_size=1, image_size=8, channels=6,
                       device="cpu", use_ddim=True, parallel_window=4)
