"""Checkpoints and the file contract of ``humanliff_tpu/train/checkpoint.py``.

- Train states: ``save_state`` / ``restore_state`` write and read one
  ``torch.save`` file per step, ``{ckpt_dir}/{step:06d}/state.pt``, a nested
  dict of plain tensors and ints (``train/stage2.py::state_payload``). The
  JAX package writes orbax directories instead, which need JAX to read
  (``scripts/export_jax_weights.py`` turns one into an npz the port reads).
- Per-subject tri-planes (``save_subject_planes`` / ``load_subject_planes``,
  ``tri_planes`` (L, 3, C3, D, D) and ``global_step`` in an npz).
- Layer samples (``save_samples_npz`` / ``load_samples_npz``, the next
  layer's x_cond, arr_0 convention) and the Stage-1 decoder sidecar
  (``load_decoder_npz``, ``/``-joined flax keys).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

STATE_FILE = "state.pt"
COMMIT_FILE = "COMMITTED"  # written last: a step directory without it is a partial save


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"{step:06d}")


def save_state(ckpt_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Save a train state (a nested dict of tensors and numbers) under
    ``ckpt_dir/{step:06d}``.

    Idempotent per step: a complete checkpoint for this step is kept. A step
    directory without the commit marker is a partial save from a crashed run:
    it is deleted and saved again."""
    path = _step_dir(ckpt_dir, step)
    if os.path.exists(path):
        if os.path.exists(os.path.join(path, COMMIT_FILE)):
            print(f"[checkpoint] step {step} already saved, keeping {path}")
            return path
        print(f"[checkpoint] removing partial checkpoint at {path}, re-saving")
        shutil.rmtree(path)
    os.makedirs(path)
    with open(os.path.join(path, STATE_FILE), "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(path, COMMIT_FILE), "w") as f:
        f.write(f"{step}\n")
        f.flush()
        os.fsync(f.fileno())
    return path


def restore_state(ckpt_dir: str, step: Optional[int] = None,
                  map_location="cpu") -> Tuple[Optional[Dict[str, Any]], int]:
    """The state saved at ``step`` (default: the latest complete one) as a
    dict, and its step; ``(None, 0)`` when there is none. Tensors are read
    lazily (memory-mapped) when ``map_location`` is the CPU."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, 0
    path = _step_dir(ckpt_dir, step)
    if not os.path.exists(os.path.join(path, COMMIT_FILE)):
        raise FileNotFoundError(f"no complete checkpoint at {path}")
    state = torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                       weights_only=True, mmap=True)
    return state, step


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest step with a complete checkpoint under ``ckpt_dir``."""
    base = os.path.abspath(ckpt_dir)
    if not os.path.isdir(base):
        return None
    steps = [int(f) for f in os.listdir(base)
             if re.fullmatch(r"\d{6}", f) and os.path.exists(os.path.join(base, f, COMMIT_FILE))]
    return max(steps) if steps else None


def get_field(restored: Dict[str, Any], name: str):
    return restored[name]


def get_ema(restored: Dict[str, Any], rate_str: str):
    """EMA params for ``rate_str``, with a single-rate fallback.

    Checkpoints are keyed by the rate string they were trained with. When the
    rate asked for is missing and exactly one rate exists, that one is used
    with a warning; with several, this raises listing them. Returns
    ``(params, rate_used)``."""
    ema = restored["ema_params"]
    if rate_str in ema:
        return ema[rate_str], rate_str
    rates = sorted(ema)
    if len(rates) == 1:
        print(f"[checkpoint] WARNING: no EMA({rate_str}) in checkpoint; "
              f"falling back to the only rate present, EMA({rates[0]})")
        return ema[rates[0]], rates[0]
    raise KeyError(f"EMA rate {rate_str!r} not in checkpoint (available: {rates}); "
                   "pass --ema_rate matching the training run")


def save_subject_planes(path: str, planes: np.ndarray, step: int) -> None:
    """Per-subject tri-plane artifact: (4, 3, C3, D, D) -> {human}_{step:06d}.npz."""
    np.savez_compressed(path, tri_planes=np.asarray(planes), global_step=step)


def load_subject_planes(path: str) -> np.ndarray:
    with np.load(path) as z:
        return z["tri_planes"]


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
