"""Dataset API over shard indexes (paper: torch Dataset semantics).

``__len__`` / ``__getitem__`` with lazy per-shard open: the shard
memmaps are opened on first touch *by the consuming thread/process* and
held in a bounded LRU (loader.py) — the paper's "open inside
__getitem__, not __init__" rule that makes multi-worker loading safe.

Port of ``repro/data/dataset.py``: the same numpy code, copied so that
the port does not import the JAX package.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from repro_torch.data.shards import ShardIndex


class ShardedDataset:
    def __init__(self, index: ShardIndex, lru_shards: int = 8):
        self.index = index
        self.lru_shards = lru_shards
        self._cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0

    def __len__(self) -> int:
        return len(self.index)

    def _shard(self, shard: int, field: str) -> np.ndarray:
        key = (shard, field)
        if key in self._cache:
            self._cache.move_to_end(key)
            self.cache_hits += 1
            return self._cache[key]
        self.cache_misses += 1
        arr = self.index.open_shard(shard, field)      # lazy open
        self._cache[key] = arr
        while len(self._cache) > self.lru_shards * len(self.index.fields):
            self._cache.popitem(last=False)            # LRU eviction
        return arr

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        shard, off = self.index.locate(int(idx))
        return {f: np.asarray(self._shard(shard, f)[off])
                for f in self.index.fields}

    def gather(self, indices) -> Dict[str, np.ndarray]:
        """Batched fetch: groups indices by shard to touch each shard
        file once (the shard-parallel load path)."""
        indices = np.asarray(indices, np.int64)
        out = {f: np.empty((len(indices),) + tuple(m["shape"]),
                           np.dtype(m["dtype"]))
               for f, m in self.index.fields.items()}
        locs = np.array([self.index.locate(int(i)) for i in indices])
        if len(locs) == 0:
            return out
        for shard in np.unique(locs[:, 0]):
            mask = locs[:, 0] == shard
            offs = locs[mask, 1]
            for f in self.index.fields:
                out[f][mask] = self._shard(int(shard), f)[offs]
        return out

    def sequence_lengths(self, length_field: Optional[str] = None
                         ) -> np.ndarray:
        """Per-record token counts for max-tokens batching. Uses the
        ``length_field`` if present, else the fixed label width."""
        if length_field and length_field in self.index.fields:
            lens = []
            for s in range(self.index.num_shards):
                lens.append(np.asarray(self.index.open_shard(
                    s, length_field)))
            return np.concatenate(lens)
        width = self.index.fields["labels"]["shape"][0]
        return np.full(len(self), width, np.int64)
