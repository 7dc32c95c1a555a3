"""Host input-pipeline prefetching (port of ``moka_tpu/data/prefetch.py``).

The host pipeline (video decode, fbank, assembly) must overlap with device
steps.  The reference relies on torch DataLoader workers; here a thread
pool maps ``__getitem__`` ahead of consumption and a small prefetch
queue keeps N batches ready while the card runs — decode/fbank release the
GIL (cv2/numpy), so threads suffice without process workers."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence


def prefetch(iterator: Iterable, size: int = 2) -> Iterator:
    """Run ``iterator`` in a background thread, keeping ``size`` items ready."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []

    def producer():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # surface in the consumer thread
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


class ParallelLoader:
    """Ordered parallel ``dataset[i]`` evaluation + collation + prefetch.

    loader = ParallelLoader(ds, collate=ds.collate, batch_size=8, workers=8)
    for batch in loader.epoch(order):  # order = permuted indices
        ...
    """

    def __init__(self, dataset, collate: Callable, batch_size: int,
                 workers: int = 8, prefetch_batches: int = 2):
        self.dataset = dataset
        self.collate = collate
        self.batch_size = batch_size
        self.workers = workers
        self.prefetch_batches = prefetch_batches

    def epoch(self, order: Sequence[int]) -> Iterator:
        def gen():
            with ThreadPoolExecutor(self.workers) as pool:
                n_full = len(order) - len(order) % self.batch_size
                items_iter = pool.map(self.dataset.__getitem__,
                                      [int(i) for i in order[:n_full]])
                buf = []
                for item in items_iter:
                    buf.append(item)
                    if len(buf) == self.batch_size:
                        yield self.collate(buf)
                        buf = []

        return prefetch(gen(), size=self.prefetch_batches)
