"""M6 — prefetching dataloader with LRU shard cache.

The paper: "with prefetch we fetch the next batch while training on the
current batch; LRU caching stores shards in memory." Here a background
thread runs the sampler's fetch+pack (pure NumPy) into a bounded queue
while the main thread feeds the device; the ShardedDataset's LRU keeps
hot shard memmaps open.

``depth`` > 1 prefetches multiple batches when host memory allows
(paper: "when memory capacity allows we can prefetch multiple batches").

Port of ``repro/data/loader.py``, copied so that the port does not
import the JAX package; ``start`` (a resume's first batch) and the
early stop are the port's: the driver re-opens an epoch after a replan,
and a consumer that stops early must not wait on a producer blocked on
a full queue.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data.sampler import HetSampler

_SENTINEL = object()


class PrefetchLoader:
    def __init__(self, sampler: HetSampler, depth: int = 2):
        self.sampler = sampler
        self.depth = max(1, depth)

    def iter_epoch(self, epoch: int, start: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches from batch ``start`` on. Closing the
        iterator early (a ``break``) stops the producer at once: it
        waits on the queue with a timeout and checks a stop flag."""
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        err: list = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self.sampler.iter_epoch(epoch, start):
                    if not put(batch):
                        return
            except BaseException as e:          # surface in consumer
                err.append(e)
            put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True,
                             name=f"prefetch-epoch{epoch}")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                yield item
            if err:
                raise err[0]
        finally:
            stop.set()
            t.join(timeout=5.0)

    def cache_stats(self) -> Dict[str, int]:
        ds = self.sampler.dataset
        return {"hits": ds.cache_hits, "misses": ds.cache_misses}
