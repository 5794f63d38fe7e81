"""M6 — prefetching dataloader with LRU shard cache.

The paper: "with prefetch we fetch the next batch while training on the
current batch; LRU caching stores shards in memory." Here a background
thread runs the sampler's fetch+pack (pure NumPy) into a bounded queue
while the main thread feeds the device; the ShardedDataset's LRU keeps
hot shard memmaps open.

``depth`` > 1 prefetches multiple batches when host memory allows
(paper: "when memory capacity allows we can prefetch multiple batches").

Port of ``repro/data/loader.py``: the same numpy code, copied so that
the port does not import the JAX package.
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

    def iter_epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        err: list = []

        def producer():
            try:
                for batch in self.sampler.iter_epoch(epoch):
                    q.put(batch)
            except BaseException as e:          # surface in consumer
                err.append(e)
            finally:
                q.put(_SENTINEL)

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
            t.join(timeout=5.0)

    def cache_stats(self) -> Dict[str, int]:
        ds = self.sampler.dataset
        return {"hits": ds.cache_hits, "misses": ds.cache_misses}
