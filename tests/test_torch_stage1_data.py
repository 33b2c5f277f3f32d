"""Port parity of Stage-1 data and metrics: ``data/synthetic.py`` (items and
held-out view items bit for bit), ``ops/rays.py`` and ``data/raygen.py`` (the ray
and AABB functions of the JAX ``data/raygen.py``, exact) and ``eval/metrics.py``
(``mse``, ``psnr``, ``ssim``: rtol 1e-6)."""

import numpy as np
import pytest

from humanliff_tpu.data import raygen as jraygen
from humanliff_tpu.data.synthetic import SyntheticLayeredDataset as JaxSynthetic
from humanliff_tpu.eval import metrics as jmetrics
from humanliff_tpu_torch.data import raygen
from humanliff_tpu_torch.ops import rays
from humanliff_tpu_torch.data.synthetic import SyntheticLayeredDataset
from humanliff_tpu_torch.eval import metrics


def _pair(**kw):
    return JaxSynthetic(**kw), SyntheticLayeredDataset(**kw)


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("index", [0, 65, 200, 511])
def test_synthetic_item_bit_for_bit(tight, index):
    theirs, ours = _pair(num_instances=2, n_rays=64, image_size=24, tight_bounds=tight)
    a = theirs.item(index, np.random.default_rng(index + 1))
    b = ours.item(index, np.random.default_rng(index + 1))
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # The default generator is the index's, in both.
    for k, v in theirs.item(index).items():
        np.testing.assert_array_equal(ours.item(index)[k], v, err_msg=k)


@pytest.mark.parametrize("inst,layer,view", [(0, 0, 145), (1, 3, 170), (1, 2, 185)])
def test_synthetic_test_item_bit_for_bit(inst, layer, view):
    theirs, ours = _pair(num_instances=2, n_rays=32, image_size=20, tight_bounds=True)
    a = theirs.test_item(inst, layer, view, n_gt_samples=48)
    b = ours.test_item(inst, layer, view, n_gt_samples=48)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert a["acc"].max() > 0.5  # the subject is in view


def test_synthetic_shapes_and_bounds():
    theirs, ours = _pair(num_instances=3, num_layers=4, tight_bounds=True)
    assert len(ours) == len(theirs) == 3 * 4 * 64
    for i in range(3):
        np.testing.assert_array_equal(ours.instance_bounds(i), theirs.instance_bounds(i))
    for name in ("centers", "base_radii", "colors", "bounds"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))


def _camera(seed):
    rng = np.random.default_rng(seed)
    ds = SyntheticLayeredDataset(image_size=16)
    K, R, T = ds._camera(int(rng.integers(0, 64)))
    return K, R, T


@pytest.mark.parametrize("seed", [0, 1])
def test_raygen_functions_match(seed):
    K, R, T = _camera(seed)
    for a, b in zip(rays.get_rays(16, 12, K, R, T), jraygen.get_rays_np(16, 12, K, R, T)):
        np.testing.assert_array_equal(a, b)
    ro, rd = jraygen.get_rays_np(16, 16, K, R, T)
    ro, rd = ro.reshape(-1, 3).astype(np.float32), rd.reshape(-1, 3).astype(np.float32)
    bounds = np.asarray([[-0.5, -0.6, -0.4], [0.5, 0.6, 0.4]], np.float32)
    for a, b in zip(rays.intersect_aabb(bounds, ro, rd),
                    jraygen.get_near_far_np(bounds, ro, rd)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(raygen.full_image_rays(16, 16, K, R, T, bounds),
                    jraygen.full_image_rays(16, 16, K, R, T, bounds)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(24, 20, 3), (30, 30), (5, 6, 3)])
def test_metrics_match(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=shape), 0, 1).astype(np.float32)
    for name in ("mse", "psnr", "ssim"):
        np.testing.assert_allclose(getattr(metrics, name)(a, b), getattr(jmetrics, name)(a, b),
                                   rtol=1e-6, err_msg=name)
    assert metrics.ssim(a, a) == pytest.approx(1.0)


def test_lpips_is_absent_without_weights():
    assert metrics.lpips_fn() is None
