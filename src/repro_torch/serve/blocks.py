"""Free-list allocation over the paged KV pool
(copy of ``repro/serve/blocks.py``).

The pool itself is a device tensor (models/kvcache.py); this module is
the host-side accountant that decides which physical blocks a sequence
owns. Blocks are partitioned across pods with the same balanced-extent
math the checkpoint writer uses to shard bucket rows across hosts
(core/buckets.py::host_shard_extents): pod p allocates only from its
contiguous [lo, hi) extent, so a sequence's cache blocks are co-located
with the pod that decodes it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core import buckets as bkt
from repro_torch.models.kvcache import PagedLayout


class BlockPool:
    """LIFO free-list over a contiguous range of physical block ids."""

    def __init__(self, layout: PagedLayout,
                 extent: Tuple[int, int] = None):
        lo, hi = extent if extent is not None else (0, layout.num_blocks)
        if not (0 <= lo <= hi <= layout.num_blocks):
            raise ValueError(
                f"extent {(lo, hi)} outside pool of {layout.num_blocks} "
                f"blocks")
        self.layout = layout
        self.extent = (lo, hi)
        self._free: List[int] = list(range(hi - 1, lo - 1, -1))
        self._allocated = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_blocks(self) -> int:
        return self.extent[1] - self.extent[0]

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"pool extent {self.extent}: need {n} blocks, "
                f"{len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b not in self._allocated:
                raise RuntimeError(f"double free of block {b}")
            self._allocated.discard(b)
            self._free.append(b)


def pod_block_pools(layout: PagedLayout, pods: int) -> List[BlockPool]:
    """Partition the pool into one balanced contiguous extent per pod."""
    return [BlockPool(layout, extent)
            for extent in bkt.host_shard_extents(layout.num_blocks, pods)]
