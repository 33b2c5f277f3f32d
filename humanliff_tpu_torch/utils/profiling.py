"""Timing and tracing (port of ``humanliff_tpu/utils/profiling.py``).

CUDA work is asynchronous: a host clock read right after a call measures the
enqueue. So every timing here ends in ``torch.cuda.synchronize`` where the
result holds CUDA tensors. ``trace`` records ``torch.profiler`` over a block
and writes a Chrome trace (``chrome://tracing``, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Iterator, List

import torch


def _tensors(out) -> Iterator[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def force_sync(out):
    """Wait for the devices of the CUDA tensors in ``out`` (a tensor, or
    dicts, lists and tuples of them) to finish; returns ``out``."""
    for device in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(device)
    return out


class Timer:
    """Accumulating section timer: ``with timer.section(name) as r:`` ... put
    the section's result in ``r["out"]`` to have it synchronized before the
    clock stops."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        result: Dict[str, Any] = {}
        try:
            yield result
        finally:
            if sync and "out" in result:
                force_sync(result["out"])
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        """Mean seconds per section, by name."""
        return {k: self.totals[k] / max(self.counts[k], 1) for k in sorted(self.totals)}


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 5, **kwargs):
    """Steady-state seconds per call of ``fn`` after ``warmup`` calls, and the
    last call's result: ``(seconds, out)``."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    force_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    force_sync(out)
    return (time.perf_counter() - t0) / iters, out


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where it is
    available); writes the Chrome trace ``{logdir}/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities: List[ProfilerActivity] = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():  # the block's kernels end inside the trace
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
