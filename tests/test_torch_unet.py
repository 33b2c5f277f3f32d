"""Port parity of the ControlNet UNet against the JAX package's flax UNetModel,
on the CPU in fp32, at the image_size-32 configuration (channel_mult
(1, 2, 2, 2) from ``channel_mult_for(32)``, attention at 16 and 8, scale-shift
norm, class labels), narrowed to 32 channels and 1 res block per level.

Weights: seeded random flax parameters (zero-init layers included, so every
path carries signal), carried to the port by ``compat/from_jax.py``.
Tolerance: max |diff| <= 2e-5 * max |out| + 1e-5: fp32 convolutions and
GroupNorm statistics summed in another order through ~20 layers.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_port_util import randomize_tree
from humanliff_tpu.compat.torch_import import unet_params_from_state_dict
from humanliff_tpu.models.factory import channel_mult_for as jax_channel_mult_for
from humanliff_tpu.models.factory import create_model as jax_create_model
from humanliff_tpu.models.nn import timestep_embedding as jax_timestep_embedding
from humanliff_tpu_torch.compat.from_jax import unet_state_dict
from humanliff_tpu_torch.models.factory import channel_mult_for, create_model
from humanliff_tpu_torch.models.nn import timestep_embedding

CFG = dict(image_size=32, in_channels=27, num_channels=32, out_channels=27,
           num_res_blocks=1, learn_sigma=False, class_cond=True,
           attention_resolutions="16,8", num_heads=2, num_heads_upsample=-1,
           use_scale_shift_norm=True, cond_type="controlnet", dropout=0.0)
LAYOUT = dict(num_res_blocks=1, channel_mult=(1, 2, 2, 2), attention_ds=(2, 4))


@pytest.fixture(scope="module")
def models():
    return _models()


def _models(seed=0):
    jmodel = jax_create_model(use_3d_aware=False, **CFG)
    x = jnp.zeros((1, 32, 32, 27))
    params = jax.jit(jmodel.init)(jax.random.key(seed), x, jnp.zeros((1,)), x,
                                  jnp.zeros((1,), jnp.int32))
    params = randomize_tree(params, seed)
    port = create_model(**CFG).eval()
    port.load_state_dict(unet_state_dict(params, **LAYOUT), strict=True)
    return jmodel, params, port


def test_channel_mult_and_timestep_embedding():
    for size in (16, 32, 64, 128, 256):
        assert channel_mult_for(size) == jax_channel_mult_for(size)
    t = np.asarray([0.0, 3.5, 999.0, 250.25], np.float32)
    for dim in (32, 33):
        np.testing.assert_allclose(
            timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jax_timestep_embedding(jnp.asarray(t), dim)), atol=1e-5)


def test_state_dict_round_trips_through_reference_importer(models):
    """Port names are the reference's: the JAX package's own torch importer
    maps the port's state dict back onto the identical flax tree."""
    _, params, port = models
    back = unet_params_from_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, **LAYOUT)
    flat_a = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_forward_matches_flax(models):
    jmodel, params, port = models
    rng = np.random.default_rng(1)
    B = 2
    x = rng.normal(size=(B, 32, 32, 27)).astype(np.float32)
    xc = rng.normal(size=(B, 32, 32, 27)).astype(np.float32)
    t = np.asarray([17.0, 912.5], np.float32)
    y = np.asarray([0, 3], np.int32)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(xc),
                                  jnp.asarray(y)))
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                   torch.from_numpy(xc).permute(0, 3, 1, 2),
                   torch.from_numpy(y).long()).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0.1  # the randomized output conv carries signal
    assert np.abs(out - ref).max() <= 2e-5 * scale + 1e-5, np.abs(out - ref).max()
