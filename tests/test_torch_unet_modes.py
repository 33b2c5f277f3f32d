"""Port parity of the UNet's other conditioning modes, 3D-aware mixing,
gradient checkpointing and the super-resolution model against the JAX
package's flax modules, on the CPU in fp32, at ``tests/test_torch_unet.py``'s
configuration (image 32, channel_mult (1, 2, 2, 2), attention at 16 and 8,
32 channels, 1 res block, 2 heads, class labels).

Weights: seeded random flax parameters (zero-init layers included), carried
to the port by ``compat/from_jax.py::unet_state_dict`` with ``strict=True``.
Tolerance of the whole model: max |diff| <= 2e-5 * max |out| + 1e-5, the
bar of ``test_torch_unet.py::test_forward_matches_flax``. The unit modules
are held to 1e-5 of their output's scale. ``use_checkpoint`` changes no
arithmetic: its forward and every parameter gradient equal those without it
exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_port_util import random_variables
from humanliff_tpu.compat.torch_import import unet_params_from_state_dict
from humanliff_tpu.models import attention as jax_attention
from humanliff_tpu.models.factory import create_model as jax_create_model
from humanliff_tpu.models.unet import SuperResModel as JaxSuperResModel
from humanliff_tpu.models.unet import UNetModel as JaxUNetModel
from humanliff_tpu.models.unet import _mix_3d_aware as jax_mix_3d_aware
from humanliff_tpu_torch.compat import from_jax
from humanliff_tpu_torch.compat.from_jax import unet_state_dict
from humanliff_tpu_torch.models import attention
from humanliff_tpu_torch.models.factory import create_model
from humanliff_tpu_torch.models.unet import (
    SuperResModel,
    fold_planes,
    mix_3d_aware,
    unroll_planes,
    upsample_bilinear,
)

CFG = dict(image_size=32, in_channels=27, num_channels=32, out_channels=27,
           num_res_blocks=1, learn_sigma=False, class_cond=True,
           attention_resolutions="16,8", num_heads=2, num_heads_upsample=-1,
           use_scale_shift_norm=True, dropout=0.0)
LAYOUT = dict(num_res_blocks=1, channel_mult=(1, 2, 2, 2), attention_ds=(2, 4))
# Every cond_type with and without 3D-aware mixing; the ControlNet flagship
# without it is test_torch_unet.py's.
MODES = [("", False), ("", True), ("concat", False), ("concat", True), ("AdaGN", False),
         ("AdaGN", True), ("cross_attention", False), ("cross_attention", True),
         ("controlnet", True)]
B = 2


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 32, 32, 27)).astype(np.float32)
    xc = rng.normal(size=(B, 32, 32, 27)).astype(np.float32)
    return x, xc, np.asarray([17.0, 912.5], np.float32), np.asarray([0, 3], np.int32)


def _pair(cond_type, use_3d_aware, seed=0):
    """(flax model, its randomized variables, the port model with them)."""
    jmodel = jax_create_model(cond_type=cond_type, use_3d_aware=use_3d_aware, **CFG)
    x = jnp.zeros((1, 32, 32, 27))
    variables = random_variables(jmodel, seed, x, jnp.zeros((1,)), x, jnp.zeros((1,), jnp.int32))
    port = create_model(cond_type=cond_type, use_3d_aware=use_3d_aware, **CFG).eval()
    port.load_state_dict(unet_state_dict(variables, **LAYOUT), strict=True)
    return jmodel, variables, port


def _assert_close(out, ref):
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0.1  # the randomized output conv carries signal
    err = np.abs(out - ref).max()
    assert err <= 2e-5 * scale + 1e-5, err


@pytest.mark.parametrize("cond_type,use_3d_aware", MODES)
def test_forward_matches_flax(cond_type, use_3d_aware):
    jmodel, variables, port = _pair(cond_type, use_3d_aware)
    x, xc, t, y = _inputs()
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(xc),
                                  jnp.asarray(y)))
    with torch.no_grad():
        out = port(_nchw(x), torch.from_numpy(t), _nchw(xc),
                   torch.from_numpy(y).long()).permute(0, 2, 3, 1).numpy()
    _assert_close(out, ref)


def test_unconditioned_model_ignores_x_cond():
    _, _, port = _pair("", False)
    x, xc, t, y = _inputs()
    with torch.no_grad():
        a = port(_nchw(x), torch.from_numpy(t), _nchw(xc), torch.from_numpy(y).long())
        b = port(_nchw(x), torch.from_numpy(t), None, torch.from_numpy(y).long())
    assert torch.equal(a, b)


def test_adagn_factory_quirk_and_constructor_units():
    """AdaGN without 3D-aware mixing has the reference's 1000 classes, and a
    3D-aware model takes the full plane channels (the JAX constructor unit)."""
    assert create_model(cond_type="AdaGN", use_3d_aware=False, **CFG).label_emb.num_embeddings == 1000
    m = create_model(cond_type="AdaGN", use_3d_aware=True, **CFG)
    assert m.label_emb.num_embeddings == 4
    assert m.input_blocks[0][0].in_channels == 9 and m.out[2].out_channels == 9
    assert m.cond_conv1.in_channels == 9 and m.cond_linear.in_features == 8 * 24
    assert create_model(cond_type="concat", use_3d_aware=False, **CFG).input_blocks[0][0].in_channels == 54


def test_3d_aware_controlnet_state_dict_is_the_reference_layout():
    """The JAX package's reference importer maps the port's 3D-aware ControlNet
    state dict back onto the identical flax tree (the reference keys of
    tests/test_3d_aware_parity.py: main-path out convs read 3x channels, the
    copy's do not)."""
    _, variables, port = _pair("controlnet", True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert sd["input_blocks.1.0.out_layers.3.weight"].shape == (32, 96, 3, 3)
    assert sd["input_blocks_cond.1.0.out_layers.3.weight"].shape == (32, 32, 3, 3)
    back = unet_params_from_state_dict(sd, **LAYOUT)
    flat_a = jax.tree_util.tree_flatten_with_path(jax.device_get(variables))[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_super_res_model_matches_flax():
    unet_kw = dict(in_channels=6, model_channels=32, out_channels=3, num_res_blocks=1,
                   attention_resolutions=(2, 4), channel_mult=(1, 2, 2, 2), num_classes=None,
                   num_heads=2, cond_type="")
    jmodel = JaxSuperResModel(unet=JaxUNetModel(**unet_kw))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
    low = rng.normal(size=(B, 8, 8, 3)).astype(np.float32)
    t = np.asarray([5.0, 640.0], np.float32)
    variables = random_variables(jmodel, 0, jnp.asarray(x), jnp.asarray(t), jnp.asarray(low))
    port = SuperResModel(**unet_kw).eval()
    port.load_state_dict(unet_state_dict(variables, **LAYOUT), strict=True)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(low)))
    with torch.no_grad():
        out = port(_nchw(x), torch.from_numpy(t), _nchw(low)).permute(0, 2, 3, 1).numpy()
    _assert_close(out, ref)


@pytest.mark.parametrize("cond_type,use_3d_aware",
                         [("controlnet", False), ("cross_attention", True)])
def test_use_checkpoint_changes_nothing(cond_type, use_3d_aware):
    """Train mode, autograd on: the checkpointed forward and every parameter
    gradient equal the plain ones bit for bit."""
    _, _, port = _pair(cond_type, use_3d_aware)
    port.train()
    x, xc, t, y = _inputs()
    outs, grads = [], []
    for flag in (False, True):
        port.use_checkpoint = flag
        port.zero_grad(set_to_none=True)
        out = port(_nchw(x), torch.from_numpy(t), _nchw(xc), torch.from_numpy(y).long())
        (out.square().mean() + out.mean()).backward()
        outs.append(out.detach())
        grads.append({n: p.grad.clone() for n, p in port.named_parameters()})
    assert torch.equal(outs[0], outs[1])
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
    assert any(g.abs().max() > 0 for g in grads[0].values())


# ---------------------------------------------------------------- unit cases


def _unit(jax_module, port_module, convert, *inputs):
    """Init the flax module on numpy ``inputs``, randomize, carry the
    variables into ``port_module`` through ``convert(sd, prefix, params)``
    and hold the two outputs together."""
    j_in = [None if a is None else jnp.asarray(a) for a in inputs]
    variables = random_variables(jax_module, 2, *j_in)
    sd = {}
    convert(sd, "m", variables["params"])
    port_module.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    ref = np.asarray(jax_module.apply(variables, *j_in))
    with torch.no_grad():
        out = port_module(*[None if a is None else torch.from_numpy(a) for a in inputs]).numpy()
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0.1
    assert np.abs(out - ref).max() <= 1e-5 * scale, np.abs(out - ref).max()


def test_cross_attention_matches_flax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    ctx = rng.normal(size=(2, 3, 24)).astype(np.float32)
    _unit(jax_attention.CrossAttention(16, 24, heads=2, dim_head=8),
          attention.CrossAttention(16, 24, heads=2, dim_head=8),
          from_jax._cross_attention, x, ctx)
    _unit(jax_attention.CrossAttention(16, None, heads=4, dim_head=4),  # self-attention
          attention.CrossAttention(16, None, heads=4, dim_head=4),
          from_jax._cross_attention, x)


def test_geglu_matches_flax():
    x = np.random.default_rng(6).normal(scale=2.0, size=(2, 5, 16)).astype(np.float32)

    def convert(sd, prefix, p):
        from_jax._dense(sd, f"{prefix}.proj", p["Dense_0"])

    _unit(jax_attention.GEGLU(24), attention.GEGLU(16, 24), convert, x)


def test_basic_transformer_block_matches_flax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 10, 16)).astype(np.float32)
    ctx = rng.normal(size=(2, 1, 32)).astype(np.float32)

    _unit(jax_attention.BasicTransformerBlock(16, 2, 8, 32),
          attention.BasicTransformerBlock(16, 2, 8, 32), from_jax._transformer_block, x, ctx)


@pytest.mark.parametrize("depth", [1, 2])
def test_spatial_transformer_matches_flax(depth):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, 5, 32)).astype(np.float32)
    ctx = rng.normal(size=(2, 1, 48)).astype(np.float32)
    jmod = jax_attention.SpatialTransformer(32, n_heads=2, d_head=16, depth=depth,
                                            context_dim=48)
    variables = random_variables(jmod, 2, jnp.asarray(x), jnp.asarray(ctx))
    port = attention.SpatialTransformer(32, 2, 16, depth, context_dim=48)
    sd = {}
    from_jax._spatial_transformer(sd, "m", variables["params"])
    port.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), jnp.asarray(ctx)))
    with torch.no_grad():
        out = port(_nchw(x), torch.from_numpy(ctx)).permute(0, 2, 3, 1).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    # The zero-initialised output projection makes a fresh block the identity.
    fresh = attention.SpatialTransformer(32, 2, 16, depth, context_dim=48)
    with torch.no_grad():
        assert torch.equal(fresh(_nchw(x), torch.from_numpy(ctx)), _nchw(x))


def test_3d_aware_unroll_mix_fold_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 4, 5, 9)).astype(np.float32)  # NHWC, 3 plane groups
    # The JAX model's unroll and fold (unet.py:341-347, :393-395).
    ref_unroll = np.concatenate(np.split(x, 3, axis=-1), axis=2)
    got = unroll_planes(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref_unroll)
    h = rng.normal(size=(2, 4, 15, 2)).astype(np.float32)
    ref_fold = np.concatenate(np.split(h, 3, axis=2), axis=-1)
    np.testing.assert_array_equal(fold_planes(_nchw(h)).permute(0, 2, 3, 1).numpy(), ref_fold)
    np.testing.assert_array_equal(fold_planes(unroll_planes(_nchw(x))).numpy(), _nchw(x).numpy())
    m = rng.normal(size=(2, 4, 12, 5)).astype(np.float32)
    ref_mix = np.asarray(jax_mix_3d_aware(jnp.asarray(m)))
    got_mix = mix_3d_aware(_nchw(m)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_mix, ref_mix, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("small,large", [(64, 256), (16, 32)])
def test_bilinear_upsampling_matches_jax_image_resize(small, large):
    """``F.interpolate(bilinear, align_corners=False, antialias=False)`` is
    ``jax.image.resize(..., "bilinear")`` when upsampling, edge pixels
    included."""
    low = np.random.default_rng(small).normal(size=(2, small, small, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(low), (2, large, large, 3), "bilinear"))
    got = upsample_bilinear(_nchw(low), (large, large)).permute(0, 2, 3, 1).numpy()
    err = np.abs(got - ref)
    assert err.max() <= 1e-5, err.max()
    for edge in (err[:, 0], err[:, -1], err[:, :, 0], err[:, :, -1]):
        assert edge.max() <= 1e-5
