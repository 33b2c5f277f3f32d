"""PyTorch/CUDA port of ``humanliff_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module names
(``ops/``, ``nerf/``, ``diffusion/``, ``models/``, ``sampling/``, ``data/``,
``mesh/``, ``eval/``, ``train/``, ``utils/``, ``cli/``) and
its public layouts (NHWC ``(B, 256, 256, 27)`` diffusion samples, ``(3, 9, D, D)``
tri-planes, ``(M, 27)`` / ``(M, 3)`` decoder inputs). It imports ``torch`` and
``numpy`` only. Entry points run on ``device="cuda"`` unless the caller asks
for the CPU; hand-written kernels live in ``csrc/`` and are built on first use
by :mod:`humanliff_tpu_torch.kernels`.
"""
