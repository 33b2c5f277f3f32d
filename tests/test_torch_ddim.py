"""Port parity of DDIM sampling and the progressive loops against the JAX
package, on the CPU in fp32.

- One ``ddim_sample`` step with a stub model, eta 0 and 0.5: atol 1e-5 (the
  bar of tests/test_torch_layered.py's ``p_sample`` case).
- Whole loops of a tiny ControlNet UNet (16^2, 27 channels, 4 respaced steps
  of 1000): ``ddim_sample_loop`` at eta 0 and 0.5, both progressive loops step
  by step, ``generate_layer(use_ddim=True)`` and ``generate_layer_progressive``.
  The port is fed the very noise the JAX keys give (x_T and every step's
  draw, recomputed from the same key splits), and must agree to atol 1e-3,
  the chain bar of tests/test_torch_layered.py (the first step multiplies the
  UNet's fp32 rounding differences by sqrt(1/alpha_bar - 1) ~ 156).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_port_util import randomize_tree
from humanliff_tpu.diffusion.respace import create_diffusion as jax_create_diffusion
from humanliff_tpu.models.factory import create_model as jax_create_model
from humanliff_tpu.sampling import layered as jlayered
from humanliff_tpu_torch.compat.from_jax import unet_state_dict
from humanliff_tpu_torch.diffusion.respace import create_diffusion
from humanliff_tpu_torch.models.factory import create_model
from humanliff_tpu_torch.sampling import layered

CFG = dict(image_size=16, in_channels=27, num_channels=32, out_channels=27,
           num_res_blocks=1, learn_sigma=False, class_cond=True,
           attention_resolutions="8", num_heads=2, num_heads_upsample=-1,
           use_scale_shift_norm=True, cond_type="controlnet", dropout=0.0)
SHAPE = (2, 16, 16, 27)


def _models():
    jmodel = jax_create_model(use_3d_aware=False, **CFG)
    x0 = jnp.zeros((1, 16, 16, 27))
    params = jax.jit(jmodel.init)(jax.random.key(0), x0, jnp.zeros((1,)), x0,
                                  jnp.zeros((1,), jnp.int32))
    params = jax.tree.map(jnp.asarray, randomize_tree(params, 4))
    port = create_model(**CFG).eval()
    port.load_state_dict(unet_state_dict(params, num_res_blocks=1, channel_mult=(1, 2),
                                         attention_ds=(2,)), strict=True)
    return jmodel, params, port


def _jax_noise(key, T):
    """x_T and the per-step noise a JAX loop draws from ``key``
    (k_init, k_loop = split(key); the steps from split(k_loop, T))."""
    k_init, k_loop = jax.random.split(key)
    x_t = torch.tensor(np.asarray(jax.random.normal(k_init, SHAPE)))
    steps = [torch.tensor(np.asarray(jax.random.normal(k, SHAPE, jnp.float32)))
             for k in jax.random.split(k_loop, T)]
    return x_t, steps


def _inputs(layer_idx=2, seed=5):
    xc = np.random.default_rng(seed).uniform(-1, 1, SHAPE).astype(np.float32)
    return xc, np.full((SHAPE[0],), layer_idx, np.int32)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_step_matches_jax(eta):
    ours = create_diffusion(steps=1000, timestep_respacing="ddim50")
    theirs = jax_create_diffusion(steps=1000, timestep_respacing="ddim50")
    object.__setattr__(theirs, "channel_axis", -1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4, 4, 6)).astype(np.float32)
    xc = rng.normal(size=x.shape).astype(np.float32)
    t = np.asarray([49, 10, 0])
    key = jax.random.key(7)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))

    def stub(x, ts, x_cond, y=None):
        return 0.3 * x - 0.2 * x_cond + 1e-3 * ts.reshape(-1, 1, 1, 1)

    ref, ref_x0 = theirs.ddim_sample(stub, jnp.asarray(x), jnp.asarray(xc), jnp.asarray(t),
                                     key, eta=eta)
    out, out_x0 = ours.ddim_sample(stub, torch.from_numpy(x), torch.from_numpy(xc),
                                   torch.from_numpy(t), torch.from_numpy(noise), eta=eta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(out_x0.numpy(), np.asarray(ref_x0), atol=1e-5)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_matches_jax(eta):
    jmodel, params, port = _models()
    jdiff = jax_create_diffusion(steps=1000, timestep_respacing="ddim4")
    object.__setattr__(jdiff, "channel_axis", -1)
    diff = create_diffusion(steps=1000, timestep_respacing="ddim4")
    xc, y = _inputs()
    key = jax.random.key(3)
    ref = jdiff.ddim_sample_loop(
        lambda x, ts, c, y: jmodel.apply(params, x, ts, c, y), SHAPE, key,
        x_cond=jnp.asarray(xc), eta=eta, model_kwargs={"y": jnp.asarray(y)})
    x_t, steps = _jax_noise(key, diff.num_timesteps)
    out = diff.ddim_sample_loop(
        layered._model_fn(port, False), SHAPE, x_cond=torch.from_numpy(xc), noise=x_t,
        step_noise=steps, eta=eta, model_kwargs={"y": torch.from_numpy(y).long()},
        device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize("kind", ["ancestral", "ddim"])
def test_progressive_loops_match_jax(kind):
    jmodel, params, port = _models()
    spec = "ddim4" if kind == "ddim" else "4"
    jdiff = jax_create_diffusion(steps=1000, timestep_respacing=spec)
    object.__setattr__(jdiff, "channel_axis", -1)
    diff = create_diffusion(steps=1000, timestep_respacing=spec)
    xc, y = _inputs()
    key = jax.random.key(9)
    jloop = (jdiff.ddim_sample_loop_progressive if kind == "ddim"
             else jdiff.p_sample_loop_progressive)
    loop = diff.ddim_sample_loop_progressive if kind == "ddim" else diff.p_sample_loop_progressive
    ref = list(jloop(lambda x, ts, c, y: jmodel.apply(params, x, ts, c, y), SHAPE, key,
                     x_cond=jnp.asarray(xc), model_kwargs={"y": jnp.asarray(y)}))
    x_t, steps = _jax_noise(key, diff.num_timesteps)
    out = list(loop(layered._model_fn(port, False), SHAPE, x_cond=torch.from_numpy(xc),
                    noise=x_t, step_noise=steps,
                    model_kwargs={"y": torch.from_numpy(y).long()}, device="cpu"))
    assert len(out) == len(ref) == diff.num_timesteps
    for i, (o, r) in enumerate(zip(out, ref)):
        for k in ("sample", "pred_xstart"):
            np.testing.assert_allclose(o[k].numpy(), np.asarray(r[k]), atol=1e-3,
                                       err_msg=f"step {i} {k}")


def test_generate_layer_ddim_matches_jax():
    jmodel, params, port = _models()
    jdiff = jax_create_diffusion(steps=1000, timestep_respacing="ddim4")
    diff = create_diffusion(steps=1000, timestep_respacing="ddim4")
    xc, _ = _inputs()
    key = jax.random.key(21)
    ref = jlayered.generate_layer(jmodel, params, jdiff, 2, jnp.asarray(xc), key, 2, 16, 27,
                                  use_ddim=True)
    x_t, steps = _jax_noise(key, diff.num_timesteps)
    out = layered.generate_layer(port, diff, 2, torch.from_numpy(xc), batch_size=2,
                                 image_size=16, channels=27, noise=x_t, step_noise=steps,
                                 device="cpu", use_ddim=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize("use_ddim", [False, True])
def test_generate_layer_progressive_matches_jax(use_ddim):
    jmodel, params, port = _models()
    spec = "ddim5" if use_ddim else "5"
    jdiff = jax_create_diffusion(steps=1000, timestep_respacing=spec)
    diff = create_diffusion(steps=1000, timestep_respacing=spec)
    key = jax.random.key(13)
    ref, ref_traj = jlayered.generate_layer_progressive(
        jmodel, params, jdiff, 1, None, key, 2, 16, 27, record_every=2, use_ddim=use_ddim)
    x_t, steps = _jax_noise(key, diff.num_timesteps)
    out, traj = layered.generate_layer_progressive(
        port, diff, 1, None, batch_size=2, image_size=16, channels=27, record_every=2,
        use_ddim=use_ddim, noise=x_t, step_noise=steps, device="cpu")
    assert [t for t, _ in traj] == [t for t, _ in ref_traj] == [4, 2, 0]
    for (_, p), (_, r) in zip(traj, ref_traj):
        assert isinstance(p, np.ndarray) and p.shape == SHAPE
        np.testing.assert_allclose(p, r, atol=1e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)
