"""Shared helpers of the ``test_torch_*`` parity tests (JAX package vs port).

Inputs and parameters are made with numpy from a seed and handed to both
packages as numpy arrays. Torch runs on one thread: the suite runs under
pytest-xdist with several workers.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)


def randomize_tree(tree, seed: int, scale: float = 1.0):
    """Replace every leaf of a (flax) param tree by seeded N(0, 1) / sqrt(fan_in)
    values, so zero-initialised layers carry signal. 1-d leaves get N(0, 0.1)
    around their own value (GroupNorm scales stay near 1)."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x, np.float32)
        if x.ndim >= 2:
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.standard_normal(x.shape) * scale / np.sqrt(fan_in)).astype(np.float32)
        return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree.map(leaf, jax.device_get(tree))


def psnr(a, b, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak**2 / mse)


def random_variables(module, seed: int, *args):
    """Seeded variables of a flax ``module`` for inputs shaped like ``args``,
    with no init run (``jax.eval_shape``: nothing is compiled): matrices and
    kernels N(0, 1) / sqrt(fan_in), norm scales 1 + N(0, 0.1), other 1-d
    leaves N(0, 0.1), as :func:`randomize_tree` makes of an init."""
    import jax

    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if getattr(path[-1], "key", None) == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
