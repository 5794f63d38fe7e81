"""Row extents (port of ``repro/core/buckets.py::host_shard_extents``).

The serving block pools split the paged KV pool across pods with this
balanced-extent math. The rest of the JAX module is the training-side
bucketed reduction and comes with the training slice.
"""
from __future__ import annotations

from typing import Tuple


def host_shard_extents(n: int, hosts: int) -> Tuple[Tuple[int, int], ...]:
    """Balanced contiguous ``[lo, hi)`` extents splitting ``n`` rows
    over ``hosts`` owners. Empty extents (``hi == lo``) appear when
    ``hosts > n``."""
    if hosts <= 0:
        raise ValueError(f"hosts must be positive, got {hosts}")
    base, rem = divmod(int(n), hosts)
    out = []
    lo = 0
    for h in range(hosts):
        hi = lo + base + (1 if h < rem else 0)
        out.append((lo, hi))
        lo = hi
    return tuple(out)
