"""Build and load the hand-written CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. It is compiled
by ``nvcc`` into ``build/torch_kernels/<name>-<hash>.so`` under the checkout (the
hash covers the source and the flags, so an edited source rebuilds) and loaded
with ``ctypes``. Nothing here includes PyTorch's headers, so a build takes
well under a minute, not many. Building happens on first use, never at
import: the CPU tests import every module on a machine without ``nvcc``.
:func:`build_host` builds the repo's host C++ libraries (``native/``) the
same way with ``g++``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Tuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
REPO_DIR = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(REPO_DIR, "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Host libraries (native/*.cpp): no -march=native, so a library built on one
# machine runs on any x86-64 host.
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

# kernel name -> launches since the last reset_launches(). Each wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {}

# name -> {"path", "seconds", "cached", "ptxas"} of this process's builds.
BUILD_LOG: Dict[str, dict] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sass(path: str) -> str:
    """The machine code of a built library, as ``cuobjdump -sass`` prints it."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    proc = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True)
    return proc.stdout


def _keyed_build(name: str, src: str, deps: Tuple[str, ...], argv: Tuple[str, ...]) -> str:
    """Compile ``src`` with ``argv`` (compiler and flags) into
    ``build/torch_kernels/<name>-<hash>.so`` unless it is there already; the
    hash covers ``src``, ``deps`` and the flags, so an edited source rebuilds.
    A failed compile raises."""
    digest = hashlib.sha256(" ".join(argv[1:]).encode())
    for path in (src, *deps):
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        BUILD_LOG.setdefault(name, {"path": out, "seconds": 0.0, "cached": True,
                                    "ptxas": ""})
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Compile to a private name and rename: a concurrent build never loads a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([*argv, "-o", tmp, src], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{argv[0]} failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"path": out, "seconds": time.perf_counter() - t0,
                       "cached": False, "ptxas": proc.stderr}
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its keyed ``.so`` is missing; return its path."""
    return _keyed_build(name, os.path.join(CSRC_DIR, f"{name}.cu"), (),
                        (_nvcc(), *NVCC_FLAGS))


def build_host(name: str, src: str, deps: Tuple[str, ...] = ()) -> str:
    """Compile the host C++ library ``src`` (with its headers ``deps``) by
    ``g++`` with :data:`HOST_CXX_FLAGS`, keyed like :func:`build`."""
    return _keyed_build(name, src, deps, ("g++", *HOST_CXX_FLAGS))


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, compiling it if needed. The
    kernel's wrapper module declares its signatures and keeps the handle."""
    return ctypes.CDLL(build(name))
