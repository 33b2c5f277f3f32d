"""The file contract of ``humanliff_tpu/train/checkpoint.py`` that needs no
JAX: layer samples (``save_samples_npz`` / ``load_samples_npz``, the next
layer's x_cond, arr_0 convention) and the Stage-1 decoder sidecar
(``load_decoder_npz``, ``/``-joined flax keys). The orbax train states are not
read here: restoring them needs JAX (``scripts/export_jax_weights.py`` turns
one into an npz that ``compat.from_jax.load_unet_npz`` reads).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def save_samples_npz(path: str, samples: np.ndarray) -> None:
    """Layer-sampling output (B, H, W, C); the next layer's x_cond input."""
    np.savez(path, np.asarray(samples))


def load_samples_npz(path: str) -> np.ndarray:
    with np.load(path) as z:
        return z[z.files[0]]


def load_decoder_npz(path: str) -> Dict[str, Any]:
    """The nested decoder param dict of a ``decoder_*.npz`` (metadata keys
    starting with ``__`` dropped)."""
    out: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            if key.startswith("__"):
                continue
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return out
