"""Stage-2 tri-plane datasets (port of ``humanliff_tpu/data/triplane_data.py``;
reference triplane_datasets.py).

All subjects' planes pack once into one float32 ``.npy`` of shape
(N, L, C, D, D), read as a memmap; an item is a slice of it. Item semantics
are the reference's (triplane_datasets.py:103-119): x = planes[subject,
layer], x_cond = planes[subject, layer - 1] (zeros at layer 0), y = the layer
index. Items are NHWC, the training layout.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from humanliff_tpu_torch.train.checkpoint import load_subject_planes


def pack_subject_planes(paths: List[str], out_path: str) -> np.ndarray:
    """Pack per-subject plane files ((L, 3, C3, D, D) ``tri_planes``) into
    one memmap-able (N, L, C, D, D) array at ``out_path``."""
    first = np.asarray(load_subject_planes(paths[0]), np.float32)
    L, D = first.shape[0], first.shape[-1]
    C = int(np.prod(first.shape[1:-2]))
    arr = np.lib.format.open_memmap(out_path, mode="w+", dtype=np.float32,
                                    shape=(len(paths), L, C, D, D))
    for i, p in enumerate(paths):
        arr[i] = np.asarray(load_subject_planes(p), np.float32).reshape(L, C, D, D)
    arr.flush()
    return arr


class TriplaneDataset:
    """Indexable (subject, layer) item source for ``BatchLoader``."""

    def __init__(self, packed_path: str, num_layers: int = 4):
        self.planes = np.load(packed_path, mmap_mode="r")
        self.num_layers = num_layers
        if self.planes.ndim != 5:
            raise ValueError(f"{packed_path}: expected (N, L, C, D, D), got {self.planes.shape}")

    def __len__(self) -> int:
        return self.planes.shape[0] * self.num_layers

    def item(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        subject, layer = divmod(index, self.num_layers)
        x = np.asarray(self.planes[subject, layer], np.float32)
        cond = (np.zeros_like(x) if layer == 0
                else np.asarray(self.planes[subject, layer - 1], np.float32))
        return {"x": x.transpose(1, 2, 0), "x_cond": cond.transpose(1, 2, 0),
                "y": np.int32(layer)}

    def flat_nhwc(self) -> np.ndarray:
        """All items as one (N*L, D, D, C) array, the device-resident table."""
        flat = np.asarray(self.planes, np.float32)
        flat = flat.reshape(-1, *flat.shape[2:]).transpose(0, 2, 3, 1)
        return np.ascontiguousarray(flat)
