"""M5 — self-describing sharded dataset format (memmap + JSON manifest).

The paper uses HDF5/h5py for self-describing, hierarchically-grouped,
multi-tensor shards. h5py is not available in this environment, so the
same design is built on raw ``.npy`` shards:

  <dir>/manifest.json                  dtypes, shapes, per-shard rows
  <dir>/shard_00000.<field>.npy        one file per field per shard

Properties preserved from the paper's design:
  * multiple dependent tensors per record ("fields"), arbitrary dtypes;
  * shards loadable in parallel (each .npy opens independently, memmap);
  * a global index: record i -> (shard, offset) via cumulative lengths
    (the paper's "accumulate the lengths of each file" class);
  * lazy open — files are opened inside ``__getitem__``, never held by
    the constructing process (the paper's fork-safety trick for
    multi-worker loading).

Port of ``repro/data/shards.py``: the same numpy code, copied so that
the port does not import the JAX package.
"""
from __future__ import annotations

import bisect
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MANIFEST = "manifest.json"


def write_shards(out_dir: str, records: Dict[str, np.ndarray],
                 rows_per_shard: int) -> "ShardIndex":
    """Split per-field arrays (same leading dim) into shard files."""
    os.makedirs(out_dir, exist_ok=True)
    fields = sorted(records)
    n = records[fields[0]].shape[0]
    for f in fields:
        if records[f].shape[0] != n:
            raise ValueError("all fields need the same number of rows")
    shards = []
    for si, start in enumerate(range(0, n, rows_per_shard)):
        stop = min(start + rows_per_shard, n)
        for f in fields:
            np.save(os.path.join(out_dir, f"shard_{si:05d}.{f}.npy"),
                    records[f][start:stop])
        shards.append(stop - start)
    manifest = {
        "version": 1,
        "fields": {f: {"dtype": str(records[f].dtype),
                       "shape": list(records[f].shape[1:])}
                   for f in fields},
        "shard_rows": shards,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1)
    return ShardIndex(out_dir)


class ShardIndex:
    """Global record index over a shard directory (host-side, cheap)."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, MANIFEST)) as fh:
            self.manifest = json.load(fh)
        self.shard_rows: List[int] = self.manifest["shard_rows"]
        self.fields: Dict[str, Dict] = self.manifest["fields"]
        self._cum = np.concatenate([[0], np.cumsum(self.shard_rows)])

    def __len__(self) -> int:
        return int(self._cum[-1])

    @property
    def num_shards(self) -> int:
        return len(self.shard_rows)

    def locate(self, idx: int) -> Tuple[int, int]:
        """global index -> (shard, offset)."""
        if idx < 0 or idx >= len(self):
            raise IndexError(idx)
        s = bisect.bisect_right(self._cum, idx) - 1
        return s, idx - int(self._cum[s])

    def shard_file(self, shard: int, field: str) -> str:
        return os.path.join(self.path, f"shard_{shard:05d}.{field}.npy")

    def open_shard(self, shard: int, field: str) -> np.ndarray:
        """Memmap one shard file (lazy: call inside __getitem__)."""
        return np.load(self.shard_file(shard, field), mmap_mode="r")
