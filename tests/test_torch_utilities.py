"""Port parity of the small single-device modules against the JAX package, on
the CPU:

- ``ops/grid_sample.py::grid_sample_2d`` against JAX's gather version on the
  golden inputs (coordinates to 1.6, outside the map), atol 1e-5;
- ``nerf/renderer.py::render_image_chunked`` (the plain decoder) against
  JAX's on a 20^2 view in ragged chunks of 128 rays: PSNR >= 45 dB on rgb,
  acc and depth (tests/test_torch_renderer.py's bar), 2 decoder calls a
  chunk;
- ``sampling/viz.py``: ``colorize_planes`` given JAX's colour matrix against
  JAX's ``triplane_to_rgb``, within one level of 255 (the uint8 cast
  truncates sums taken in another order);
- ``utils/profiling.py``: ``Timer`` keeps JAX's sections and counts,
  ``timed`` returns the call's result, ``trace`` writes a Chrome trace;
- ``utils/runtime.py``: ``HL_DEBUG_NANS`` turns anomaly detection on (JAX:
  ``jax_debug_nans``), SIGUSR1 is registered with faulthandler.
"""

import faulthandler
import json
import signal

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from golden_cases import grid_sample_inputs
from torch_port_util import psnr
from humanliff_tpu.data.raygen import full_image_rays
from humanliff_tpu.data.view_datasets import NovelViewCameras
from humanliff_tpu.nerf import renderer as jrender
from humanliff_tpu.nerf.decoder import NeRFDecoder as JaxDecoder
from humanliff_tpu.ops.grid_sample import grid_sample_2d as jax_grid_sample_2d
from humanliff_tpu.sampling.viz import triplane_to_rgb as jax_triplane_to_rgb
from humanliff_tpu.utils import profiling as jax_profiling
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.nerf import renderer
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder
from humanliff_tpu_torch.ops.grid_sample import grid_sample_2d
from humanliff_tpu_torch.sampling.viz import colorize_planes, triplane_to_rgb
from humanliff_tpu_torch.utils import profiling
from humanliff_tpu_torch.utils.runtime import setup_runtime

BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)


@pytest.mark.parametrize("H,W,C", [(16, 16, 3), (32, 16, 9)])
def test_grid_sample_2d_matches_jax(H, W, C):
    img, grid = grid_sample_inputs(H, W, C)
    ref = np.asarray(jax_grid_sample_2d(jnp.asarray(img), jnp.asarray(grid)))
    out = grid_sample_2d(torch.from_numpy(img), torch.from_numpy(grid)).numpy()
    assert out.shape == (len(grid), C)
    assert (np.abs(ref).sum(-1) == 0).any()  # some coordinates fall outside
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_render_image_chunked_matches_jax():
    rng = np.random.default_rng(0)
    D = 24
    g = (np.arange(D) + 0.5) / D * 2 - 1
    u, v = np.meshgrid(g, g, indexing="xy")
    planes = (0.5 * rng.normal(size=(3, 9, D, D))
              + 2.0 * np.exp(-3.0 * (u ** 2 + v ** 2))[None, None]).astype(np.float32)
    dec = JaxDecoder()
    params = jax.device_get(dec.init(jax.random.key(0), jnp.zeros((1, 27)), jnp.zeros((1, 3))))
    port = NeRFDecoder()
    port.load_state_dict(decoder_state_dict(params))
    calls = []
    counted = lambda *a: calls.append(1) or port(*a)  # noqa: E731

    S, chunk = 20, 128
    K, R, T = NovelViewCameras(S).camera(2)
    ro, rd, near, far, _ = full_image_rays(S, S, K, R, T, BOUNDS)
    cfg = dict(n_samples=16, n_importance=16, perturb=True, density_noise=True)
    ref = jrender.render_image_chunked(
        dec, params, jnp.asarray(planes), jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(near),
        jnp.asarray(far), jnp.asarray(BOUNDS), jrender.RenderConfig(**cfg), chunk=chunk)
    out = renderer.render_image_chunked(counted, torch.from_numpy(planes), ro, rd, near, far,
                                        BOUNDS, renderer.RenderConfig(**cfg), chunk=chunk)
    assert len(calls) == 2 * -(-S * S // chunk)
    assert float(np.asarray(ref["rgb"]).std()) > 0.01
    for k in ("rgb", "acc", "depth"):
        assert out[k].shape == ref[k].shape == (S * S,) + ref[k].shape[1:]
        assert psnr(out[k].numpy(), ref[k]) >= 45.0, k


@pytest.mark.parametrize("shape", [(3, 9, 16, 16), (27, 12, 12)])
def test_colorize_planes_matches_jax(shape):
    planes = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = jax_triplane_to_rgb(jnp.asarray(planes), seed=4)
    colorize = np.array(jax.random.normal(jax.random.key(4), (3, 9)))
    out = colorize_planes(torch.from_numpy(planes), torch.from_numpy(colorize))
    D = shape[-1]
    assert out.dtype == np.uint8 and out.shape == ref.shape == (D, 3 * D, 3)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    mine = triplane_to_rgb(torch.from_numpy(planes), seed=4)
    assert mine.shape == (D, 3 * D, 3) and mine.dtype == np.uint8
    np.testing.assert_array_equal(mine, triplane_to_rgb(torch.from_numpy(planes), seed=4))
    assert mine.min() == 0 and mine.max() >= 254  # each tile is min-max normalised


def test_timer_timed_and_trace(tmp_path):
    port, ref = profiling.Timer(), jax_profiling.Timer()
    for timer, lib in ((port, torch), (ref, jnp)):
        for name in ("a", "b", "a"):
            with timer.section(name) as r:
                r["out"] = {"x": lib.ones(3), "y": [lib.zeros(2)]}
        with timer.section("c", sync=False):
            pass
    assert port.counts == ref.counts == {"a": 2, "b": 1, "c": 1}
    assert list(port.summary()) == list(ref.summary()) == ["a", "b", "c"]
    assert all(v >= 0 for v in port.summary().values())

    seconds, out = profiling.timed(torch.add, torch.ones(4), 2.0, warmup=2, iters=3)
    assert seconds >= 0 and torch.equal(out, torch.full((4,), 3.0))
    x = {"a": (torch.ones(2),)}
    assert profiling.force_sync(x) is x

    with profiling.trace(str(tmp_path / "trace")):
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_setup_runtime(monkeypatch):
    monkeypatch.delenv("HL_DEBUG_NANS", raising=False)
    setup_runtime()
    assert not torch.is_anomaly_enabled()
    assert faulthandler.unregister(signal.SIGUSR1)  # it was registered
    monkeypatch.setenv("HL_DEBUG_NANS", "1")
    try:
        setup_runtime()
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"), \
                pytest.warns(UserWarning, match="SqrtBackward0"):
            torch.sqrt(x - 1.0).sum().backward()  # NaN in the backward of sqrt
    finally:
        torch.autograd.set_detect_anomaly(False)
        faulthandler.unregister(signal.SIGUSR1)
