"""A minimal numpy DataLoader: shuffling, batching and drop_last (the port's
own copy of the sequential path of cdlnet_tpu/data/loader.py, so that the
batches and their order are the JAX package's).

Datasets are indexable objects returning numpy arrays (C, ...) in [0, 1].
The loader stacks them into (N, C, ...) float32 batches in the calling
thread, as the reference did with its default num_workers=0
(data.py:47-50). Epoch order is driven by a numpy Generator reseeded per
epoch for reproducibility.
"""

from __future__ import annotations

import numpy as np


class ThreadSafeRng:
    """Per-call child generators spawned from one seeded root: each dataset
    item draws from its own child, as the JAX package's loader does, so a
    seed gives the same crops and flips in both packages."""

    def __init__(self, seed):
        self._root = np.random.default_rng(seed)

    def __call__(self):
        return self._root.spawn(1)[0]


class DataLoader:
    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
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
            yield np.stack([np.asarray(self.dataset[int(i)], dtype=np.float32)
                            for i in sel])
