"""Runtime setup shared by the entry points (port of
``humanliff_tpu/utils/runtime.py``).

- ``HL_DEBUG_NANS=1`` turns on ``torch.autograd.set_detect_anomaly(True)``: a
  backward that produces NaN raises, naming the forward op. The reference
  left anomaly detection on globally (lib/fields.py:2); here it is opt-in,
  as the JAX package's ``jax_debug_nans`` tripwire is.
- ``SIGUSR1`` dumps every thread's stack to stderr (``faulthandler``), to tell
  a long run that hangs from one that works.

The JAX module's other two settings have no counterpart: the persistent XLA
compilation cache (PyTorch compiles nothing here; the CUDA kernels are built
once into ``build/torch_kernels/``, ``kernels.py``) and the ``HL_PLATFORM``
override (each CLI's ``--device`` picks the device).
"""

from __future__ import annotations

import faulthandler
import os
import signal

import torch


def setup_runtime() -> None:
    if os.environ.get("HL_DEBUG_NANS"):
        torch.autograd.set_detect_anomaly(True)
    try:
        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except (ValueError, RuntimeError):  # stderr has no file descriptor (a captured stream)
        pass
