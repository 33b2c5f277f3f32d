"""Port parity of the diffusion core and the layered sampler against the JAX
package, on the CPU in fp32.

- Respacing and schedule tables: exact (both float64 numpy).
- ``p_mean_variance`` / ``p_sample`` with a stub model: atol 1e-5.
- The 4-layer ``generate_all_layers`` chain of a tiny ControlNet UNet (16^2,
  27 channels, 4 respaced steps of 1000, y = k, x_cond = the previous layer):
  the JAX package samples with its own keys, and the port is fed the very
  noise those keys give (x_T and every step's draw, recomputed here from the
  same key splits), so the chains must agree to atol 1e-3: the first step
  turns eps into x_0 with sqrt(1/alpha_bar - 1) ~ 156 at t = 999, which
  multiplies the UNet's fp32 rounding differences (~1e-6) to ~2e-4 (measured),
  and 16 chained steps follow.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_port_util import randomize_tree
from humanliff_tpu.diffusion.respace import create_diffusion as jax_create_diffusion
from humanliff_tpu.diffusion.respace import space_timesteps as jax_space_timesteps
from humanliff_tpu.models.factory import create_model as jax_create_model
from humanliff_tpu.sampling import layered as jlayered
from humanliff_tpu_torch.compat.from_jax import unet_state_dict
from humanliff_tpu_torch.diffusion.respace import create_diffusion, space_timesteps
from humanliff_tpu_torch.models.factory import create_model
from humanliff_tpu_torch.sampling import layered

TABLES = ("betas", "alphas_cumprod", "sqrt_recip_alphas_cumprod",
          "sqrt_recipm1_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1",
          "posterior_mean_coef2", "timestep_map")


@pytest.mark.parametrize("spec", ["250", "ddim25", "10,20,30", "4"])
def test_respacing_and_tables_exact(spec):
    assert space_timesteps(1000, spec) == jax_space_timesteps(1000, spec)
    ours = create_diffusion(steps=1000, timestep_respacing=spec)
    theirs = jax_create_diffusion(steps=1000, timestep_respacing=spec)
    assert ours.num_timesteps == theirs.num_timesteps
    for name in TABLES:
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))


@pytest.mark.parametrize("variant", ["fixed_large", "fixed_small", "learned_range",
                                     "predict_xstart"])
def test_p_mean_variance_and_p_sample(variant):
    kw = {"fixed_large": {}, "fixed_small": {"sigma_small": True},
          "learned_range": {"learn_sigma": True},
          "predict_xstart": {"predict_xstart": True}}[variant]
    ours = create_diffusion(steps=1000, timestep_respacing="50", **kw)
    theirs = jax_create_diffusion(steps=1000, timestep_respacing="50", **kw)
    object.__setattr__(theirs, "channel_axis", -1)  # NHWC, as bench.py sets it
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4, 4, 6)).astype(np.float32)
    xc = rng.normal(size=x.shape).astype(np.float32)
    noise = rng.normal(size=x.shape).astype(np.float32)
    t = np.asarray([49, 10, 0])

    def stub(x, ts, x_cond, y=None):  # depends on x, the scaled t and x_cond
        out = 0.3 * x - 0.2 * x_cond + 1e-3 * ts.reshape(-1, 1, 1, 1)
        if variant == "learned_range":  # the variance half, in [-1, 1]
            if isinstance(x, torch.Tensor):
                return torch.cat([out, torch.tanh(x)], -1)
            return jnp.concatenate([out, jnp.tanh(x)], -1)
        return out

    ref = theirs.p_mean_variance(stub, jnp.asarray(x), jnp.asarray(t), jnp.asarray(xc))
    out = ours.p_mean_variance(stub, torch.from_numpy(x), torch.from_numpy(t),
                               torch.from_numpy(xc))
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5, err_msg=k)
    sample, _ = ours.p_sample(stub, torch.from_numpy(x), torch.from_numpy(xc),
                              torch.from_numpy(t), torch.from_numpy(noise))
    nonzero = (t != 0).astype(np.float32).reshape(-1, 1, 1, 1)
    expect = np.asarray(ref["mean"]) + nonzero * np.exp(
        0.5 * np.asarray(ref["log_variance"])) * noise
    np.testing.assert_allclose(sample.numpy(), expect, atol=1e-5)


def test_planes_image_round_trip():
    x = np.random.default_rng(1).normal(size=(8, 8, 27)).astype(np.float32)
    planes = layered.planes_image_to_triplane(torch.from_numpy(x))
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(jlayered.planes_image_to_triplane(jnp.asarray(x))))
    np.testing.assert_array_equal(layered.triplane_to_planes_image(planes).numpy(), x)
    assert layered.LAYER_NAMES == jlayered.LAYER_NAMES


def _jax_chain_noise(key, num_layers, shape, T):
    """The noise jlayered.generate_all_layers draws: per layer, split the key,
    then p_sample_loop's x_T and its per-step keys (gaussian.py:319-332)."""
    noises = []
    for _ in range(num_layers):
        key, sub = jax.random.split(key)
        k_init, k_loop = jax.random.split(sub)
        x_t = np.asarray(jax.random.normal(k_init, shape))
        steps = [torch.tensor(np.asarray(jax.random.normal(k, shape, jnp.float32)))
                 for k in jax.random.split(k_loop, T)]
        noises.append((torch.tensor(x_t), steps))
    return noises


def test_four_layer_chain_matches_jax():
    cfg = dict(image_size=16, in_channels=27, num_channels=32, out_channels=27,
               num_res_blocks=1, learn_sigma=False, class_cond=True,
               attention_resolutions="8", num_heads=2, num_heads_upsample=-1,
               use_scale_shift_norm=True, cond_type="controlnet", dropout=0.0)
    jmodel = jax_create_model(use_3d_aware=False, **cfg)
    x0 = jnp.zeros((1, 16, 16, 27))
    params = jax.jit(jmodel.init)(jax.random.key(0), x0, jnp.zeros((1,)), x0,
                                  jnp.zeros((1,), jnp.int32))
    params = jax.tree.map(jnp.asarray, randomize_tree(params, 2))
    port = create_model(**cfg).eval()
    port.load_state_dict(unet_state_dict(params, num_res_blocks=1, channel_mult=(1, 2),
                                         attention_ds=(2,)), strict=True)

    jdiff = jax_create_diffusion(steps=1000, timestep_respacing="4")
    diff = create_diffusion(steps=1000, timestep_respacing="4")
    key = jax.random.key(11)
    shape = (2, 16, 16, 27)
    ref = jlayered.generate_all_layers(jmodel, params, jdiff, key, batch_size=2,
                                       image_size=16, channels=27)
    out = layered.generate_all_layers(
        port, diff, batch_size=2, image_size=16, channels=27,
        noises=_jax_chain_noise(key, 4, shape, diff.num_timesteps), device="cpu")
    assert list(out) == list(ref) == layered.LAYER_NAMES
    prev = None
    for name in layered.LAYER_NAMES:
        a, b = out[name].numpy(), np.asarray(ref[name])
        assert a.shape == shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-3, err_msg=name)
        if prev is not None:  # layers differ: y and x_cond reach the model
            assert np.abs(a - prev).max() > 1e-2
        prev = a
