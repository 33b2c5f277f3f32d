"""Port parity of the fused NeRF decoder (plain version, autograd.Function and
the NeRFDecoder module) against the JAX package's Pallas kernel in interpret
mode and its flax NeRFDecoder, on the CPU.

Tolerances: fp32 outputs atol 1e-5, as tests/test_pallas_decoder.py holds the
Pallas kernel; gradients atol 1e-4, as there. Where values reach the hundreds
(summed-loss weight gradients, the fitted decoder on unit-scale features) an
rtol of 1e-5 is added: fp32 rounding of 155-term sums in another order.
bf16 inputs are rounded the same way in both packages and promoted to fp32,
so they keep the fp32 bound.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_port_util import randomize_tree  # noqa: F401  (sets torch threads)
from humanliff_tpu.nerf.decoder import NeRFDecoder as JaxDecoder
from humanliff_tpu.ops.pallas.decoder import fused_decoder as jax_fused
from humanliff_tpu.ops.pallas.decoder import weights_from_decoder_vars
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder
from humanliff_tpu_torch.ops.fused_decoder import decoder_plain, fused_decoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FITTED = os.path.join(REPO, "runs", "quality", "train", "decoder_060000.npz")


def _setup(M=300, seed=0):
    dec = JaxDecoder()
    params = dec.init(jax.random.key(seed), jnp.zeros((1, 27)), jnp.zeros((1, 3)))
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(M, 27)).astype(np.float32)
    dirs = rng.normal(size=(M, 3)).astype(np.float32)
    port = NeRFDecoder()
    port.load_state_dict(decoder_state_dict(jax.device_get(params)))
    return dec, params, port, feats, dirs


def _torch_weights(jax_weights):
    return tuple(torch.from_numpy(np.asarray(w).T.copy()) if np.ndim(w) == 2
                 else torch.from_numpy(np.asarray(w).copy()) for w in jax_weights)


def test_plain_matches_pallas_interpret_and_flax():
    dec, params, _, feats, dirs = _setup()
    jw = weights_from_decoder_vars(params)
    rgb_k, alpha_k = jax_fused(jw, jnp.asarray(feats), jnp.asarray(dirs), True)
    rgb_f, alpha_f = dec.apply(params, jnp.asarray(feats), jnp.asarray(dirs))
    rgb, alpha = decoder_plain(_torch_weights(jw), torch.from_numpy(feats),
                               torch.from_numpy(dirs))
    for ref_rgb, ref_alpha in ((rgb_k, alpha_k), (rgb_f, alpha_f)):
        np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), atol=1e-5)
        np.testing.assert_allclose(alpha.numpy(), np.asarray(ref_alpha), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("full", [True, False])
def test_module_matches_flax(dtype, full):
    """The port module (its wrapper takes the plain version on CPU tensors) vs
    flax NeRFDecoder on inputs of the given dtype; density-only when not full."""
    dec, params, port, feats, dirs = _setup(M=257, seed=1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jf = jnp.asarray(feats).astype(jdt)
    jd = jnp.asarray(dirs).astype(jdt) if full else None
    rgb_ref, alpha_ref = dec.apply(params, jf, jd)
    tf = torch.from_numpy(feats).to(tdt)
    td = torch.from_numpy(dirs).to(tdt) if full else None
    with torch.no_grad():
        rgb, alpha = port(tf, td)
    assert alpha.dtype == torch.float32 and alpha.shape == (257, 1)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_ref, np.float32), atol=1e-5)
    if full:
        np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref, np.float32), atol=1e-5)
    else:
        assert rgb is None and rgb_ref is None


def test_gradients_match_jax_grad():
    """Backward of the autograd.Function (plain recompute) vs jax.grad through
    the Pallas kernel's custom VJP, for the features and all 14 weights."""
    dec, params, _, feats, dirs = _setup(M=128)
    jw = weights_from_decoder_vars(params)

    def loss(w, f):
        rgb, alpha = jax_fused(w, f, jnp.asarray(dirs), True)
        return (rgb**2).sum() + (alpha**2).sum()

    gw_ref, gf_ref = jax.grad(loss, argnums=(0, 1))(jw, jnp.asarray(feats))

    tw = [w.requires_grad_(True) for w in _torch_weights(jw)]
    tf = torch.from_numpy(feats).requires_grad_(True)
    rgb, alpha = fused_decoder(tw, tf, torch.from_numpy(dirs))
    ((rgb**2).sum() + (alpha**2).sum()).backward()

    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf_ref), atol=1e-4)
    for g, ref in zip(tw, gw_ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.grad.numpy(), ref.T if ref.ndim == 2 else ref,
                                   atol=1e-4, rtol=1e-5)


def test_density_only_gradients():
    dec, params, port, feats, _ = _setup(M=64, seed=2)
    jf = jnp.asarray(feats)
    g_ref = jax.grad(lambda f: (dec.apply(params, f)[1] ** 2).sum())(jf)
    tf = torch.from_numpy(feats).requires_grad_(True)
    _, alpha = port(tf)
    (alpha**2).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(g_ref), atol=1e-4)


def test_fitted_decoder_loads_from_npz():
    """The repo's fitted Stage-1 decoder (flat ``params/<layer>/...`` npz keys)
    loads strictly and decodes as the JAX decoder does (fp32, atol 1e-5)."""
    flat = dict(np.load(FITTED))
    port = NeRFDecoder()
    port.load_state_dict(decoder_state_dict(flat), strict=True)
    jparams = {"params": {}}
    for k, v in flat.items():
        if k.startswith("params/"):
            _, layer, name = k.split("/")
            jparams["params"].setdefault(layer, {})[name] = jnp.asarray(v)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(200, 27)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    rgb_ref, alpha_ref = JaxDecoder().apply(jparams, jnp.asarray(feats), jnp.asarray(dirs))
    with torch.no_grad():
        rgb, alpha = port(torch.from_numpy(feats), torch.from_numpy(dirs))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad", ["shape", "dtype", "dirs_shape", "weights"])
def test_wrapper_rejects_bad_arguments(bad):
    _, _, port, feats, dirs = _setup(M=16)
    w = port.weights()
    f = torch.from_numpy(feats)
    d = torch.from_numpy(dirs)
    if bad == "shape":
        f = f[:, :26]
    elif bad == "dtype":
        f, d = f.double(), d.double()
    elif bad == "dirs_shape":
        d = d[:8]
    else:
        w = w[:-1]
    with pytest.raises((ValueError, TypeError)):
        fused_decoder(w, f, d)
