"""Batch loading (port of ``humanliff_tpu/data/loader.py``).

A thread pool assembles numpy batches of seeded random items while the
device runs the current step. The JAX module's ``device_prefetch`` is not
ported: the training CLI copies each batch to the card itself, or keeps the
dataset there (``--device_data``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


class BatchLoader:
    """Infinite batch iterator over an indexable item source.

    ``item_fn(idx, rng) -> dict[str, np.ndarray]``; items are stacked along
    axis 0. Each of ``num_workers`` threads draws item indices uniformly with
    replacement from its own generator, seeded ``seed + 1 + worker``, into a
    queue of its own, and the iterator takes the workers' batches in turn, so
    the sequence of batches depends on the seed alone (two loaders with one
    seed give the same batches, as several ranks' index loaders must). An
    exception in a worker is raised by the iterator, not left to hang it.
    """

    def __init__(
        self,
        num_items: int,
        item_fn: Callable[[int, np.random.Generator], Dict[str, np.ndarray]],
        batch_size: int,
        seed: int = 0,
        num_workers: int = 2,
        queue_depth: int = 4,
    ):
        self.num_items = num_items
        self.item_fn = item_fn
        self.batch_size = batch_size
        n = max(1, num_workers)
        self._queues = [queue.Queue(maxsize=max(1, queue_depth // n)) for _ in range(n)]
        self._next = 0
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, args=(seed + 1 + w, self._queues[w]),
                             daemon=True)
            for w in range(n)
        ]
        for t in self._threads:
            t.start()

    def _worker(self, seed: int, out: queue.Queue):
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            idxs = rng.integers(0, self.num_items, self.batch_size)
            try:
                items = [self.item_fn(int(i), rng) for i in idxs]
                batch = {k: np.stack([it[k] for it in items], axis=0) for k in items[0]}
            except Exception as exc:  # handed to the consumer
                batch = exc
            while not self._stop.is_set():
                try:
                    out.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            batch = self._queues[self._next].get()
            self._next = (self._next + 1) % len(self._queues)
            if isinstance(batch, Exception):
                raise batch
            yield batch

    def close(self, timeout: float = 5.0):
        """Stop the workers and wait for them."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
