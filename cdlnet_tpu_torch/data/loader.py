"""A minimal numpy DataLoader: shuffling, batching, drop_last and thread-pool
workers (the port's own copy of cdlnet_tpu/data/loader.py, so that the
batches and their order are the JAX package's).

Datasets are indexable objects returning numpy arrays (C, ...) in [0, 1].
The loader stacks them into (N, C, ...) float32 batches. Epoch order is
driven by a numpy Generator reseeded per epoch for reproducibility.

num_workers > 0 assembles batches in a thread pool that persists across
epochs and keeps `prefetch` batches in flight beyond the one being
consumed; num_workers=0 assembles them in the calling thread, as the
reference did with its default (data.py:47-50). PIL's PNG decode holds the
interpreter lock for much of its time, so threads mostly overlap the
loader with the caller's device work rather than decode with decode.
"""

from __future__ import annotations

import threading
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class ThreadSafeRng:
    """Per-call child generators spawned from one seeded root: each dataset
    item draws from its own child, as the JAX package's loader does, so a
    seed gives the same crops and flips in both packages. The spawn is
    serialized by a lock (numpy Generators are not thread-safe); the draws
    from a child run in parallel. With num_workers > 0 which item gets which
    child depends on thread scheduling, so augmented runs are not
    bit-reproducible, as with torch DataLoader workers."""

    def __init__(self, seed):
        self._root = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            return self._root.spawn(1)[0]


class DataLoader:
    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False, seed=0,
                 num_workers=0, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self._epoch = 0
        self._pool = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        """The index arrays of one epoch, in order."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(idx)
        self._epoch += 1
        for start in range(0, n, self.batch_size):
            sel = idx[start : start + self.batch_size]
            if self.drop_last and len(sel) < self.batch_size:
                return
            yield sel

    def _assemble(self, sel):
        return np.stack([np.asarray(self.dataset[int(i)], dtype=np.float32) for i in sel])

    def __iter__(self):
        if self.num_workers <= 0:
            for sel in self._batches():
                yield self._assemble(sel)
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            # nothing else shuts the pool down: release its threads when the
            # loader is collected
            weakref.finalize(self, self._pool.shutdown, wait=False)
        pending = []
        try:
            for sel in self._batches():
                pending.append(self._pool.submit(self._assemble, sel))
                if len(pending) > self.prefetch:
                    yield pending.pop(0).result()
            while pending:
                yield pending.pop(0).result()
        finally:
            for f in pending:  # the consumer stopped early: drop the work queued
                f.cancel()
