"""Host-side input pipeline: threaded prefetching batch loader.

The port's copy of ``effi_mvs_plus_tpu/data/loader.py``: a thread pool
decodes samples (PIL and numpy release the GIL for the heavy work) and the
loader yields collated numpy batches, which the train and eval steps move
to the device.  All samples of a batch must agree in shape.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


def _collate(samples):
    """Stack a list of sample pytrees into batched numpy arrays."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: _collate([s[k] for s in samples]) for k in first}
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    if isinstance(first, (float, int, np.floating, np.integer)):
        return np.asarray(samples)
    return samples  # strings etc.


class Loader:
    """Iterable over collated batches with background prefetch.  With
    ``shuffle`` the order of epoch e is a permutation drawn from
    ``numpy.random.default_rng(seed + e)``.  ``indices`` restricts the
    loader to those samples, in that order before shuffling: a rank's
    shard in multi-process training."""

    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=4,
                 drop_last=False, seed=0, prefetch=4, indices=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.indices = None if indices is None else np.asarray(list(indices))
        self._epoch = 0

    def _n_samples(self):
        return (len(self.dataset) if self.indices is None
                else len(self.indices))

    def __len__(self):
        n = self._n_samples()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = (np.arange(len(self.dataset)) if self.indices is None
               else self.indices.copy())
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator:
        batches = self._batch_indices()
        self._epoch += 1
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, b))
                        out_q.put(_collate(samples))
            except BaseException as e:  # surface worker errors to consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
