"""Host-side prefetch: the next batch is assembled while the device runs
the current step.

A copy of ``cv_diffusion_tpu/data/prefetch.py``: one background thread
drains the underlying loader (whose decode and augmentation run GIL-free in
the native C++ pipeline, or in numpy) into a small bounded queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

_SENTINEL = object()


class PrefetchLoader:
    """Wraps any epoch-iterable loader with a depth-``prefetch`` queue.

    Re-iterable: each ``__iter__`` starts a fresh producer thread over one
    epoch of the underlying loader. An exception in the producer is raised
    in the consumer.
    """

    def __init__(self, loader, prefetch: int = 2):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.loader = loader
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def dataset(self):
        return getattr(self.loader, "dataset", None)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        err = []
        stop = threading.Event()

        def produce():
            try:
                for batch in self.loader:
                    if stop.is_set():
                        return
                    q.put(batch)
                    if stop.is_set():
                        return
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                yield item
        finally:
            # The consumer stopped early (break, next(iter(...))): tell the
            # producer, so that it assembles at most one more batch, and
            # drain the queue until it has ended.
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
        if err:
            raise err[0]
