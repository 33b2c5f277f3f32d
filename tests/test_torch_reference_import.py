"""Port ``compat/torch_import.py`` (the reference's own PyTorch checkpoints)
against the JAX importer and against the reference's attention.

- Stage 1: the golden reference-named decoder state dict through both
  importers; the port ``NeRFDecoder`` against JAX's flax decoder, atol 2e-5.
  A ``.tar`` with ``module.`` prefixes and the fine-tune file that holds only
  ``tri_planes``, through ``torch.save``.
- The UNet, from a seeded reference-named state dict of a tiny ControlNet
  UNet (image 16, 32 channels, attention at 8; numpy, seed 0):
  - with ``qkv_layout="jax"`` the port equals the JAX UNet that
    ``unet_params_from_state_dict`` builds, at 1 and 2 heads;
  - with the default ``"reference"`` layout an ``AttentionBlock`` and the
    whole UNet equal the same weights run through the head-major attention of
    improved-diffusion's text (``AttentionBlock.forward`` and
    ``QKVAttention.forward``, written out below), at 2 heads and at 2 heads
    with 4 in the decoder (``num_heads_upsample``).
  Tolerance: max |diff| <= 2e-5 * max |out| + 1e-5 (fp32; sums in another
  order), as tests/test_torch_unet.py.

Named divergence from the JAX package: its importer
(``humanliff_tpu/compat/torch_import.py::_attn``) copies the qkv rows as they
are, so at more than one head a reference checkpoint attends through the
wrong rows there. The port permutes them by default; the tests pin the
reference's attention, and JAX's behaviour only under ``qkv_layout="jax"``.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from golden_cases import decoder_state_dict
from humanliff_tpu.compat import torch_import as jax_import
from humanliff_tpu.models.factory import create_model as jax_create_model
from humanliff_tpu.nerf.decoder import NeRFDecoder as JaxDecoder
from humanliff_tpu_torch.compat import torch_import
from humanliff_tpu_torch.models.attention import AttentionBlock
from humanliff_tpu_torch.models.factory import create_model
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder

CFG = dict(image_size=16, in_channels=27, num_channels=32, out_channels=27,
           num_res_blocks=1, learn_sigma=False, class_cond=True,
           attention_resolutions="8", use_scale_shift_norm=True,
           cond_type="controlnet", dropout=0.0)
LAYOUT = dict(num_res_blocks=1, channel_mult=(1, 2), attention_ds=(2,))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _close(out, ref):
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0.1
    err = np.abs(out - ref).max()
    assert err <= 2e-5 * scale + 1e-5, err


def _port(num_heads, num_heads_upsample=-1):
    return create_model(num_heads=num_heads, num_heads_upsample=num_heads_upsample,
                        **CFG).eval()


def _reference_state_dict(num_heads, num_heads_upsample=-1, seed=0):
    """Seeded numpy values under the reference's key names (the port's), with
    ``module.`` prefixes as a DDP checkpoint has them: matrices N(0, 1) /
    sqrt(fan_in), GroupNorm scales 1 + N(0, 0.1), other vectors N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in _port(num_heads, num_heads_upsample).state_dict().items():
        if v.dim() >= 2:
            a = rng.standard_normal(tuple(v.shape)) / math.sqrt(v[0].numel())
        else:
            a = float(k.endswith("weight")) + 0.1 * rng.standard_normal(tuple(v.shape))
        sd[f"module.{k}"] = a.astype(np.float32)
    return sd


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 16, 16, 27)).astype(np.float32)
    xc = rng.normal(size=(2, 16, 16, 27)).astype(np.float32)
    return x, xc, np.asarray([17.0, 912.5], np.float32), np.asarray([0, 3], np.int32)


def _run(port, x, xc, t, y):
    with torch.no_grad():
        return port(_nchw(x), torch.from_numpy(t), _nchw(xc),
                    torch.from_numpy(y).long()).permute(0, 2, 3, 1).numpy()


def reference_attention(block, x, qkv_weight, qkv_bias, num_heads):
    """improved-diffusion's ``AttentionBlock.forward`` with
    ``QKVAttention.forward``: the qkv output reshaped to (B * heads,
    3 * head_dim, T) and only then split into q, k, v, so the rows of
    ``qkv_weight`` / ``qkv_bias`` are head-major. ``block`` supplies the
    norm and proj_out."""
    b, c, *spatial = x.shape
    x = x.reshape(b, c, -1)
    qkv = F.conv1d(block.norm(x), qkv_weight, qkv_bias)
    qkv = qkv.reshape(b * num_heads, -1, qkv.shape[2])
    ch = qkv.shape[1] // 3
    q, k, v = torch.split(qkv, ch, dim=1)
    scale = 1 / math.sqrt(math.sqrt(ch))
    weight = torch.einsum("bct,bcs->bts", q * scale, k * scale)
    weight = torch.softmax(weight.float(), dim=-1).type(weight.dtype)
    a = torch.einsum("bts,bcs->bct", weight, v)
    h = block.proj_out(a.reshape(b, -1, a.shape[-1]))
    return (x + h).reshape(b, c, *spatial)


def _with_reference_attention(port):
    """``port`` with each ``AttentionBlock`` running :func:`reference_attention`
    over its own (unpermuted) qkv parameters."""
    for module in port.modules():
        if isinstance(module, AttentionBlock):
            module.forward = (lambda m: lambda x: reference_attention(
                m, x, m.qkv.weight, m.qkv.bias, m.num_heads))(module)
    return port


# --------------------------------------------------------------------------
# Stage 1
# --------------------------------------------------------------------------


def test_decoder_matches_the_jax_import():
    sd = decoder_state_dict()
    port = NeRFDecoder()
    port.load_state_dict(torch_import.stage1_params_from_state_dict(sd)["decoder"], strict=True)
    jax_vars = jax_import.stage1_params_from_state_dict(sd)["decoder"]
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(64, 27)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ref_rgb, ref_alpha = JaxDecoder().apply(jax_vars, jnp.asarray(feats), jnp.asarray(dirs))
    with torch.no_grad():
        rgb, alpha = port(torch.from_numpy(feats), torch.from_numpy(dirs))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref_alpha), atol=2e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), atol=2e-5)


def test_stage1_tar_with_module_prefixes(tmp_path):
    sd = {f"module.{k}": torch.from_numpy(v.copy()) for k, v in decoder_state_dict().items()}
    planes = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 4, 3, 9, 8, 8)).astype(np.float32))
    sd["module.tri_planes"] = planes
    path = str(tmp_path / "060000.tar")
    torch.save({"global_step": 60000, "network_fn_state_dict": sd,
                "optimizer_state_dict": {"param_groups": [{"lr": 5e-4, "betas": (0.9, 0.999)}]}},
               path)
    got, step = torch_import.import_stage1_checkpoint(path)
    ref, ref_step = jax_import.import_stage1_checkpoint(path)
    assert step == ref_step == 60000
    assert got["planes"].dtype == torch.float32 and tuple(got["planes"].shape) == (2, 4, 3, 9, 8, 8)
    np.testing.assert_array_equal(got["planes"].numpy(), ref["planes"])
    port = NeRFDecoder()
    port.load_state_dict(got["decoder"], strict=True)
    for k, v in decoder_state_dict().items():
        np.testing.assert_array_equal(port.state_dict()[k].numpy(), v)


def test_stage1_finetune_file_holds_only_planes(tmp_path):
    planes = np.random.default_rng(2).normal(size=(1, 4, 3, 9, 8, 8)).astype(np.float32)
    path = str(tmp_path / "subject_002000.tar")
    torch.save({"tri_planes": torch.from_numpy(planes)}, path)
    got, step = torch_import.import_stage1_checkpoint(path)
    assert step == 0 and set(got) == {"planes"}
    np.testing.assert_array_equal(got["planes"].numpy(), planes)
    with pytest.raises(ValueError, match="tri_planes"):
        torch_import.stage1_params_from_state_dict({"tri_planes": planes[0]})


# --------------------------------------------------------------------------
# The UNet
# --------------------------------------------------------------------------


@pytest.mark.parametrize("num_heads", [1, 2])
def test_jax_layout_matches_the_jax_importer(num_heads):
    sd = _reference_state_dict(num_heads)
    port = _port(num_heads)
    port.load_state_dict(torch_import.unet_state_dict_from_reference(sd, port, "jax"),
                         strict=True)
    jmodel = jax_create_model(num_heads=num_heads, num_heads_upsample=-1, use_3d_aware=False,
                              **CFG)
    variables = jax_import.unet_params_from_state_dict(sd, **LAYOUT)
    x, xc, t, y = _inputs()
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(xc), jnp.asarray(y)))
    _close(_run(port, x, xc, t, y), ref)


@pytest.mark.parametrize("num_heads", [2, 4])
def test_attention_block_matches_the_head_major_reference(num_heads):
    rng = np.random.default_rng(3)
    C = 64
    raw = {"norm.weight": 1 + 0.1 * rng.standard_normal(C),
           "norm.bias": 0.1 * rng.standard_normal(C),
           "qkv.weight": rng.standard_normal((3 * C, C, 1)) / math.sqrt(C),
           "qkv.bias": 0.1 * rng.standard_normal(3 * C),
           "proj_out.weight": rng.standard_normal((C, C, 1)) / math.sqrt(C),
           "proj_out.bias": 0.1 * rng.standard_normal(C)}
    raw = {k: v.astype(np.float32) for k, v in raw.items()}
    block = AttentionBlock(C, num_heads).eval()
    block.load_state_dict(torch_import.unet_state_dict_from_reference(raw, block), strict=True)
    x = torch.from_numpy(rng.standard_normal((2, C, 4, 4)).astype(np.float32))
    with torch.no_grad():
        out = block(x)
        ref = reference_attention(block, x, torch.from_numpy(raw["qkv.weight"]),
                                  torch.from_numpy(raw["qkv.bias"]), num_heads)
    _close(out.numpy(), ref.numpy())
    # qkv_to_reference inverts the permutation.
    w = torch.from_numpy(raw["qkv.weight"])
    assert torch.equal(torch_import.qkv_to_reference(torch_import.qkv_to_port(w, num_heads),
                                                     num_heads), w)


@pytest.mark.parametrize("num_heads,num_heads_upsample", [(2, -1), (2, 4)])
def test_reference_layout_unet_matches_the_head_major_reference(num_heads, num_heads_upsample):
    sd = _reference_state_dict(num_heads, num_heads_upsample)
    model = _port(num_heads, num_heads_upsample)
    model.load_state_dict(torch_import.unet_state_dict_from_reference(sd, model), strict=True)
    heads = {n: m.num_heads for n, m in model.named_modules() if isinstance(m, AttentionBlock)}
    assert set(heads) == {"input_blocks.3.1", "middle_block.1", "output_blocks.0.1",
                          "output_blocks.1.1", "input_blocks_cond.3.1"}
    if num_heads_upsample == 4:
        assert heads["output_blocks.0.1"] == 4 and heads["middle_block.1"] == 2
    reference = _port(num_heads, num_heads_upsample)
    reference.load_state_dict({k[7:]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    _with_reference_attention(reference)
    x, xc, t, y = _inputs()
    _close(_run(model, x, xc, t, y), _run(reference, x, xc, t, y))


def test_layouts_agree_at_one_head_and_differ_at_two(tmp_path):
    """At one head the head-major rows are [q | k | v]: both layouts load the
    same weights. At two they differ, and the JAX importer's layout (rows as
    they are) no longer computes the reference's attention."""
    sd = _reference_state_dict(1)
    one = _port(1)
    assert all(torch.equal(a, b) for a, b in zip(
        torch_import.unet_state_dict_from_reference(sd, one).values(),
        torch_import.unet_state_dict_from_reference(sd, one, "jax").values()))

    sd = _reference_state_dict(2)
    path = str(tmp_path / "ema_0.9999_200000.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    ours = torch_import.import_unet_checkpoint(path, _port(2)).eval()
    like_jax = torch_import.import_unet_checkpoint(path, _port(2), qkv_layout="jax").eval()
    reference = _port(2)
    reference.load_state_dict({k[7:]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    _with_reference_attention(reference)
    x, xc, t, y = _inputs()
    ref = _run(reference, x, xc, t, y)
    _close(_run(ours, x, xc, t, y), ref)
    gap = np.abs(_run(like_jax, x, xc, t, y) - ref).max()
    assert gap > 100 * (2e-5 * np.abs(ref).max() + 1e-5), (
        f"the JAX importer's qkv layout should diverge from the reference at 2 heads: {gap}")


def test_strict_load_names_missing_and_unexpected_keys(tmp_path):
    sd = _reference_state_dict(2)
    del sd["module.middle_block.1.qkv.bias"]
    path = str(tmp_path / "model.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    with pytest.raises(RuntimeError, match=r"middle_block\.1\.qkv\.bias"):
        torch_import.import_unet_checkpoint(path, _port(2))
    sd = _reference_state_dict(2)
    sd["module.extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match=r"extra\.weight"):
        _port(2).load_state_dict(torch_import.unet_state_dict_from_reference(sd, _port(2)),
                                 strict=True)
    with pytest.raises(ValueError, match="qkv_layout"):
        torch_import.unet_state_dict_from_reference(sd, _port(2), "head_major")
