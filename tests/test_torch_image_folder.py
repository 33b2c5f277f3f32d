"""Port parity of ``data/image_folder.py`` (a copy of the JAX package's
module) against the JAX functions, mirroring ``tests/test_image_folder.py``:
the listing and the class-from-filename rule, batches of the infinite
generator, the deterministic order, ``area_downsample``, the empty
directory. Images are written by the port's own PNG writer. Both packages
load the same files through PIL, so the arrays are equal exactly.
"""

import numpy as np
import pytest

from humanliff_tpu.data import image_folder as jax_folder
from humanliff_tpu_torch.data.image_folder import (
    ImageFolderDataset,
    area_downsample,
    list_image_files,
    load_image_data,
)
from humanliff_tpu_torch.utils.video import write_png


@pytest.fixture
def folder(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "sub"
    d.mkdir()
    for cls in ("dog", "cat"):
        for i in range(3):
            write_png(str(d / f"{cls}_{i}.png"), rng.integers(0, 255, (48, 64, 3), np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")
    return str(tmp_path)


def test_listing_and_classes(folder):
    files = list_image_files(folder)
    assert files == jax_folder.list_image_files(folder)
    assert len(files) == 6 and files == sorted(files)
    ds = ImageFolderDataset(folder, image_size=16, class_cond=True)
    ref = jax_folder.ImageFolderDataset(folder, image_size=16, class_cond=True)
    # Classes from the filename prefix before "_", sorted: cat=0, dog=1.
    assert ds.classes == ref.classes == [0, 0, 0, 1, 1, 1]
    for i in range(len(ds)):
        x, y = ds.item(i)
        x_ref, y_ref = ref.item(i)
        assert x.shape == (16, 16, 3) and x.dtype == np.float32 and y == y_ref
        np.testing.assert_array_equal(x, x_ref)
        assert x.min() >= -1.0 and x.max() <= 1.0
    assert ImageFolderDataset(folder, 16).item(0)[1] is None


def test_generator_batches(folder):
    it = load_image_data(folder, batch_size=4, image_size=16, class_cond=True, seed=3)
    ref = jax_folder.load_image_data(folder, batch_size=4, image_size=16, class_cond=True,
                                     seed=3)
    # Infinite: draws more batches than the dataset holds, shuffled by the seed.
    for _ in range(4):
        b, b_ref = next(it), next(ref)
        assert b["x"].shape == (4, 16, 16, 3) and b["y"].shape == (4,)
        assert b["x"].dtype == np.float32 and b["y"].dtype == np.int32
        np.testing.assert_array_equal(b["x"], b_ref["x"])
        np.testing.assert_array_equal(b["y"], b_ref["y"])
    assert "y" not in next(load_image_data(folder, 2, 16))


def test_deterministic_order(folder):
    a = next(load_image_data(folder, 6, 16, deterministic=True))
    b = next(load_image_data(folder, 6, 16, deterministic=True))
    np.testing.assert_array_equal(a["x"], b["x"])
    ds = ImageFolderDataset(folder, 16)
    np.testing.assert_array_equal(a["x"], np.stack([ds.item(i)[0] for i in range(6)]))


def test_area_downsample_matches_mean():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    lo = area_downsample(x, 4)
    assert lo.shape == (2, 4, 4, 3)
    np.testing.assert_array_equal(lo, jax_folder.area_downsample(x, 4))
    np.testing.assert_allclose(lo[0, 0, 0], x[0, :2, :2].mean(axis=(0, 1)), rtol=1e-6)
    with pytest.raises(ValueError):
        area_downsample(x, 3)


def test_empty_dir_raises(tmp_path):
    with pytest.raises(ValueError):
        ImageFolderDataset(str(tmp_path), 16)
