"""Port parity of LPIPS (``eval/lpips.py``, ``eval/metrics.py::lpips_fn``,
``compat/lpips_import.py``) against the JAX package's ``eval/lpips_jax.py``,
on the CPU in fp32.

The real VGG weights are not in the repository: the math runs with seeded
random weights, on the tiny pyramid of tests/test_lpips.py (within rtol 1e-5
of ``lpips_distance``) and on the full VGG16 tower at 64^2 (within rtol
1e-4: thirteen fp32 convolutions summed in another order). The weights gate
and the npz schema are tested with files written here, and the converter
against a stand-in ``lpips`` module put into ``sys.modules``.
"""

import sys
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from humanliff_tpu.compat import lpips_import as jax_lpips_import
from humanliff_tpu.eval import lpips_jax
from humanliff_tpu_torch.compat import lpips_import
from humanliff_tpu_torch.eval import lpips as tl
from humanliff_tpu_torch.eval import metrics

TINY_CFG = (8, "M", 16, "M", 16)
TINY_SLICES = (1, 2, 3)


def _params(cfg, slices, seed, full=False):
    """Seeded weights in the npz schema (HWIO convs, lin per slice)."""
    rng = np.random.default_rng(seed)
    params, cin, ci, chans = {}, 3, 0, []
    for c in cfg:
        if c == "M":
            continue
        std = np.sqrt(2.0 / (9 * cin)) if full else 0.2
        params[f"conv{ci}_w"] = rng.normal(0, std, (3, 3, cin, c)).astype(np.float32)
        params[f"conv{ci}_b"] = rng.normal(0, 0.01 if full else 0.05, (c,)).astype(np.float32)
        cin, ci = c, ci + 1
        chans.append(c)
    for li, sl in enumerate(slices):
        params[f"lin{li}"] = rng.uniform(0, 1, (chans[sl - 1],)).astype(np.float32)
    return params


def _port(params, cfg, slices):
    return tl.LPIPS(cfg, slices).load_npz_params(params).eval()


def _nchw(x):
    return torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy())


def _images(seed, n, size):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 7])
def test_tiny_pyramid_matches_jax(seed):
    params = _params(TINY_CFG, TINY_SLICES, seed)
    a, b = _images(seed + 1, 2, 18)  # odd pooled sizes: the floor semantics
    want = np.asarray(lpips_jax.lpips_distance({k: jnp.asarray(v) for k, v in params.items()},
                                               jnp.asarray(a), jnp.asarray(b),
                                               cfg=TINY_CFG, slices=TINY_SLICES))
    net = _port(params, TINY_CFG, TINY_SLICES)
    with torch.no_grad():
        got = net(_nchw(a), _nchw(b)).numpy()
        feats = net.features(_nchw(a))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jfeats = lpips_jax.vgg_features({k: jnp.asarray(v) for k, v in params.items()},
                                    (jnp.asarray(a) - lpips_jax._SHIFT) / lpips_jax._SCALE,
                                    cfg=TINY_CFG, slices=TINY_SLICES)
    assert [tuple(f.shape) for f in feats] == [
        (2, f.shape[3], f.shape[1], f.shape[2]) for f in jfeats]


def test_tiny_identity_symmetry_positivity():
    net = _port(_params(TINY_CFG, TINY_SLICES, 0), TINY_CFG, TINY_SLICES)
    a, b = (_nchw(x) for x in _images(1, 2, 16))
    with torch.no_grad():
        np.testing.assert_allclose(net(a, a).numpy(), 0.0, atol=1e-6)
        np.testing.assert_allclose(net(a, b).numpy(), net(b, a).numpy(), rtol=1e-6)
        assert (net(a, b) > 0).all()


def test_constants_match_jax():
    assert tl.VGG16_CFG == lpips_jax.VGG16_CFG and tl.VGG16_SLICES == lpips_jax.VGG16_SLICES
    np.testing.assert_array_equal(tl._SHIFT, lpips_jax._SHIFT)
    np.testing.assert_array_equal(tl._SCALE, lpips_jax._SCALE)


@pytest.fixture(scope="module")
def vgg_weights(tmp_path_factory):
    params = _params(tl.VGG16_CFG, tl.VGG16_SLICES, 0, full=True)
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz")
    np.savez(path, **params)
    return params, path


def test_full_vgg16_tower_matches_jax_through_the_weights_gate(vgg_weights, monkeypatch):
    """The full tower at 64^2 with seeded weights, read from an npz through
    HL_LPIPS_WEIGHTS by both packages' gated entry points."""
    params, path = vgg_weights
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    monkeypatch.setenv("HL_LPIPS_WEIGHTS", path)
    assert tl.default_weights_path() == path
    fn = metrics.lpips_fn("cpu")
    assert fn is not None
    got = fn(a, b)
    want = lpips_jax.make_lpips(path)(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got > 0
    net = _port(params, tl.VGG16_CFG, tl.VGG16_SLICES)
    with torch.no_grad():
        direct = float(net(_nchw(a[None] * 2 - 1), _nchw(b[None] * 2 - 1))[0])
    np.testing.assert_allclose(direct, got, rtol=1e-6)


def test_weights_gate_closed_without_a_file(monkeypatch, tmp_path):
    monkeypatch.setenv("HL_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    monkeypatch.setattr(tl, "default_weights_path", lambda: None)
    monkeypatch.setitem(sys.modules, "lpips", None)  # no torch lpips package either
    assert tl.make_lpips() is None
    assert metrics.lpips_fn("cpu") is None


def test_npz_round_trip(tmp_path):
    params = _params(TINY_CFG, TINY_SLICES, 2)
    path = str(tmp_path / "w.npz")
    np.savez(path, **params)
    loaded = tl.load_weights(path)
    assert set(loaded) == set(params)
    a, b = (_nchw(x) for x in _images(4, 1, 8))
    with torch.no_grad():
        np.testing.assert_array_equal(_port(loaded, TINY_CFG, TINY_SLICES)(a, b).numpy(),
                                      _port(params, TINY_CFG, TINY_SLICES)(a, b).numpy())


def _fake_lpips_module(seed=5):
    """A stand-in for the torch ``lpips`` package: ``LPIPS(net="vgg")`` with
    ``net.slice1..5`` (convs, ReLUs, pools of the tiny pyramid) and ``lins``
    whose ``model[-1]`` is the 1x1 channel weighting; each instance has the
    same seeded weights."""
    nn = torch.nn
    gen = torch.Generator()

    def conv(cin, cout):
        c = nn.Conv2d(cin, cout, 3, padding=1)
        with torch.no_grad():
            c.weight.copy_(0.2 * torch.randn(c.weight.shape, generator=gen))
            c.bias.copy_(0.05 * torch.randn(c.bias.shape, generator=gen))
        return c

    def lin(c):
        m = nn.Conv2d(c, 1, 1, bias=False)
        with torch.no_grad():
            m.weight.copy_(torch.rand(m.weight.shape, generator=gen))
        return types.SimpleNamespace(model=nn.Sequential(nn.Dropout(), m))

    class LPIPS:
        def __init__(self, net):
            assert net == "vgg"
            gen.manual_seed(seed)
            self.net = types.SimpleNamespace(
                slice1=nn.Sequential(conv(3, 8), nn.ReLU()),
                slice2=nn.Sequential(nn.MaxPool2d(2), conv(8, 16), nn.ReLU()),
                slice3=nn.Sequential(nn.MaxPool2d(2), conv(16, 16), nn.ReLU()),
                slice4=nn.Sequential(), slice5=nn.Sequential())
            self.lins = [lin(8), lin(16), lin(16)]

    return types.SimpleNamespace(LPIPS=LPIPS)


def test_converter_writes_the_jax_schema(tmp_path, monkeypatch):
    """Both packages' converters write the same arrays from the same torch
    ``lpips`` net; the port's ``load_weights`` and the JAX package's read
    them back to the same distance."""
    monkeypatch.setitem(sys.modules, "lpips", _fake_lpips_module())
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    lpips_import.main(["--out", ours])
    jax_lpips_import.main(["--out", theirs])
    a_z, b_z = np.load(ours), np.load(theirs)
    assert sorted(a_z.files) == sorted(b_z.files) == sorted(
        [f"conv{i}_{k}" for i in range(3) for k in "wb"] + [f"lin{i}" for i in range(3)])
    for k in a_z.files:
        np.testing.assert_array_equal(a_z[k], b_z[k])
    assert a_z["conv1_w"].shape == (3, 3, 8, 16)  # HWIO
    a, b = _images(6, 1, 16)
    want = np.asarray(lpips_jax.lpips_distance(lpips_jax.load_weights(theirs), jnp.asarray(a),
                                               jnp.asarray(b), cfg=TINY_CFG,
                                               slices=TINY_SLICES))
    with torch.no_grad():
        got = _port(tl.load_weights(ours), TINY_CFG, TINY_SLICES)(_nchw(a), _nchw(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
