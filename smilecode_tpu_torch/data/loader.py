"""Batch loader: numpy dataset items -> NDHWC tensors on an explicit device.

Counterpart of `smilecode_tpu/data/loader.py:Loader`, with its arguments and
its batch order: indices are shuffled in place, once per epoch, by one
``np.random.default_rng(seed)`` that lives as long as the loader, so both
loaders yield the same order. Items (tuples of (1, D, H, W) arrays) are
stacked to (B, D, H, W, 1) and keep their dtype.

With ``num_workers`` > 0, a pool of worker threads builds the numpy batches
ahead, at most ``max(prefetch, num_workers)`` of them in flight, and the
loader yields them in order. The pinning and the copy to the device stay on
the consuming thread: pinned when the device is a GPU, copied with
``non_blocking=True`` so the copy overlaps work already queued on the card.

While a `torch.profiler` records, each batch handed out is a span
``loader.next`` (`utils.profiling.span`) from the consumer's request to the
batch, the yield left out, over ``loader.wait`` (a worker's batch) or
``loader.build`` (building it on the consumer when ``num_workers`` is 0)
and ``loader.copy`` (pinning and the copy to the device); no spans
otherwise.
"""

from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from smilecode_tpu_torch.utils.profiling import span


def _to_ndhwc(arr: np.ndarray) -> np.ndarray:
    # (1, D, H, W) -> (D, H, W, 1)
    if arr.ndim != 4 or arr.shape[0] != 1:
        raise ValueError(f"expected (1, D, H, W) item, got {arr.shape}")
    return np.moveaxis(arr, 0, -1)


class Loader:
    """Iterates ``dataset`` in batches of ``batch_size`` on ``device``.

    Args:
      dataset: indexable with __len__ and __getitem__ -> tuple of numpy arrays.
      batch_size: leading batch dim of the stacked output.
      shuffle: reshuffle indices each epoch.
      seed: RNG seed for shuffling.
      num_workers: batch-building threads (0 = synchronous).
      prefetch: batches built ahead of the consumer.
      drop_last: drop the trailing partial batch.
      device: where batches go.

    Spans (while a profiler records): ``loader.next`` per batch, over
    ``loader.wait`` or ``loader.build`` and ``loader.copy``.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 24,
                 num_workers: int = 4, prefetch: int = 2, drop_last: bool = False,
                 device="cpu"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> list[np.ndarray]:
        """This epoch's index batches (advances the shuffle)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        n = len(idx)
        stop = n - n % self.batch_size if self.drop_last else n
        return [idx[i:i + self.batch_size] for i in range(0, stop, self.batch_size)]

    def _numpy_batch(self, indices):
        items = [self.dataset[int(i)] for i in indices]
        return [np.stack([_to_ndhwc(np.asarray(it[c])) for it in items])
                for c in range(len(items[0]))]

    def _to_device(self, cols):
        out = []
        for col in cols:
            t = torch.from_numpy(col)
            if self.device.type == "cuda":
                t = t.pin_memory()
            out.append(t.to(self.device, non_blocking=True))
        return tuple(out)

    def __iter__(self) -> Iterator:
        batches = self._batches()
        if self.num_workers == 0:
            for b in batches:
                with span("loader.next"):
                    with span("loader.build"):
                        cols = self._numpy_batch(b)
                    with span("loader.copy"):
                        batch = self._to_device(cols)
                yield batch
            return
        pool = ThreadPoolExecutor(self.num_workers, thread_name_prefix="loader")
        ahead = max(self.prefetch, self.num_workers)
        pending = collections.deque()
        todo = iter(batches)
        try:
            for _ in batches:
                with span("loader.next"):
                    # keep ahead + 1 builds in flight, then take the oldest
                    for b in itertools.islice(todo, ahead + 1 - len(pending)):
                        pending.append(pool.submit(self._numpy_batch, b))
                    with span("loader.wait"):
                        cols = pending.popleft().result()
                    with span("loader.copy"):
                        batch = self._to_device(cols)
                yield batch
        finally:
            # also on an abandoned iteration: drop queued batches, join workers
            pool.shutdown(wait=True, cancel_futures=True)
