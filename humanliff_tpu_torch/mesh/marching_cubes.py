"""ctypes binding of the native marching-cubes library (port of
``humanliff_tpu/mesh/marching_cubes.py``; it replaces the reference's PyMCubes,
renderer.py:342-343).

The library is built from ``native/marching_cubes.cpp`` by
:func:`humanliff_tpu_torch.kernels.build_host` into ``build/torch_kernels/`` at
first use, keyed by a hash of the source. The checked-in ``native/libhlmc.so``
is never loaded: it was built with ``-march=native`` on another host.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from humanliff_tpu_torch import kernels

NATIVE_DIR = os.path.join(kernels.REPO_DIR, "native")
NAME = "libhlmc"

_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        path = kernels.build_host(NAME, os.path.join(NATIVE_DIR, "marching_cubes.cpp"),
                                  (os.path.join(NATIVE_DIR, "mc_tables.h"),))
        lib = ctypes.CDLL(path)
        lib.hl_marching_cubes.restype = ctypes.c_int
        lib.hl_marching_cubes.argtypes = [
            _FLOAT_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(_FLOAT_P), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.hl_smooth.restype = None
        lib.hl_smooth.argtypes = [_FLOAT_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
        lib.hl_free.restype = None
        lib.hl_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _grid(grid: np.ndarray) -> np.ndarray:
    if np.ndim(grid) != 3:
        raise ValueError(f"expected a 3-d grid, got shape {np.shape(grid)}")
    return np.ascontiguousarray(grid, np.float32)


def smooth_grid(grid: np.ndarray, iters: int = 1) -> np.ndarray:
    """Box smoothing (mcubes.smooth's stand-in) of a copy of ``grid``."""
    g = _grid(grid).copy()
    _library().hl_smooth(g.ctypes.data_as(_FLOAT_P), *g.shape, iters)
    return g


def marching_cubes(grid: np.ndarray, iso: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """The iso-surface of ``grid`` (values below ``iso`` are inside): verts
    (V, 3) fp32 in grid coordinates and tris (T, 3) int32."""
    lib = _library()
    g = _grid(grid)
    vp, tp = _FLOAT_P(), ctypes.POINTER(ctypes.c_int32)()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.hl_marching_cubes(g.ctypes.data_as(_FLOAT_P), *g.shape, ctypes.c_float(iso),
                               ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp),
                               ctypes.byref(nt))
    try:
        # The library returns -1 when an allocation fails, which malloc(0) of
        # an empty surface may also do.
        if nv.value == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
        if rc != 0:
            raise MemoryError("marching cubes could not allocate its output")
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
        tris = np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy()
    finally:
        lib.hl_free(ctypes.cast(vp, ctypes.c_void_p))
        lib.hl_free(ctypes.cast(tp, ctypes.c_void_p))
    return verts, tris
