"""Image-folder dataset for the legacy improved-diffusion flows (port of
``humanliff_tpu/data/image_folder.py``, a copy: that module needs no JAX, but
the port imports nothing of the JAX package).

Equivalent of the reference's ``improved_diffusion/image_datasets.py``: recursive
image listing, class labels parsed from the filename prefix before the first
underscore (:30-36), the reference's resize recipe (repeated 2x BOX downsampling
while the short side is >= 2x the target, then a final resize and center crop,
:61-78), and values scaled to [-1, 1]. Used by ``cli/image_nll`` and
``cli/sr_train`` (the super-res pair loader area-pools the low-res input like
``load_superres_data``'s F.interpolate(mode="area")).

Host-side numpy/PIL code — batches come out NHWC float32, the layout of the
diffusion code (the reference is NCHW torch); the caller moves them to the
device.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_EXTS = {"jpg", "jpeg", "png", "gif", "bmp"}


def list_image_files(data_dir: str) -> List[str]:
    """All image files under ``data_dir``, recursively, sorted (reference
    ``_list_image_files_recursively``)."""
    out = []
    for root, _, names in os.walk(data_dir):
        for n in names:
            if n.rsplit(".", 1)[-1].lower() in _EXTS:
                out.append(os.path.join(root, n))
    return sorted(out)


def _load_resized(path: str, image_size: int) -> np.ndarray:
    """Load one image -> (image_size, image_size, 3) uint8, reference recipe."""
    from PIL import Image

    with Image.open(path) as img:
        img.load()
        # Repeated BOX halving keeps the final LANCZOS/BICUBIC cheap + aliasing-free.
        while min(*img.size) >= 2 * image_size:
            img = img.resize(tuple(x // 2 for x in img.size), resample=Image.BOX)
        scale = image_size / min(*img.size)
        img = img.resize(
            tuple(round(x * scale) for x in img.size), resample=Image.BICUBIC
        )
        arr = np.array(img.convert("RGB"))
    h_off = (arr.shape[0] - image_size) // 2
    w_off = (arr.shape[1] - image_size) // 2
    return arr[h_off : h_off + image_size, w_off : w_off + image_size]


class ImageFolderDataset:
    """Indexable item source: (image HWC float32 in [-1, 1], class index | None)."""

    def __init__(self, data_dir: str, image_size: int, class_cond: bool = False):
        self.files = list_image_files(data_dir)
        if not self.files:
            raise ValueError(f"no image files under {data_dir}")
        self.image_size = image_size
        self.classes: Optional[List[int]] = None
        if class_cond:
            names = [os.path.basename(p).split("_")[0] for p in self.files]
            table = {x: i for i, x in enumerate(sorted(set(names)))}
            self.classes = [table[n] for n in names]

    def __len__(self) -> int:
        return len(self.files)

    def item(self, i: int) -> Tuple[np.ndarray, Optional[int]]:
        arr = _load_resized(self.files[i], self.image_size)
        x = arr.astype(np.float32) / 127.5 - 1.0
        y = None if self.classes is None else self.classes[i]
        return x, y


def load_image_data(
    data_dir: str,
    batch_size: int,
    image_size: int,
    class_cond: bool = False,
    deterministic: bool = False,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite generator of ``{"x": (B, H, W, C) [-1, 1], "y"?: (B,)}``
    (reference ``load_data``; NHWC instead of NCHW)."""
    ds = ImageFolderDataset(data_dir, image_size, class_cond)
    rng = np.random.default_rng(seed)
    order = np.arange(len(ds))
    pos = len(ds)
    while True:
        xs, ys = [], []
        for _ in range(batch_size):
            if pos >= len(ds):
                if not deterministic:
                    rng.shuffle(order)
                pos = 0
            x, y = ds.item(int(order[pos]))
            pos += 1
            xs.append(x)
            ys.append(y)
        batch = {"x": np.stack(xs)}
        if class_cond:
            batch["y"] = np.asarray(ys, np.int32)
        yield batch


def area_downsample(x: np.ndarray, small: int) -> np.ndarray:
    """(B, H, W, C) -> (B, small, small, C) mean pooling — the super-res pair
    low-res input (reference load_superres_data F.interpolate(mode="area"))."""
    B, H, W, C = x.shape
    if H % small or W % small:
        raise ValueError(f"({H}, {W}) does not pool evenly to {small}")
    fh, fw = H // small, W // small
    return x.reshape(B, small, fh, small, fw, C).mean(axis=(2, 4))
