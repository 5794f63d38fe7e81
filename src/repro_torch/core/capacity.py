"""Capacity planner for heterogeneous ranks (port of ``repro/core/capacity.py``).

Only what the serving router reads: :class:`CapacityPlan` and
:func:`plan_capacities`, the largest-remainder allocation of rows to
ranks in proportion to their capacity scores. Host-side numpy, copied
so that the port does not import the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Assignment of real rows to DP ranks for one plan window."""

    capacities: np.ndarray        # (R,) relative capacity scores
    rows_per_rank: np.ndarray     # (R,) real rows n_i assigned per rank
    buffer_rows: int              # uniform per-rank buffer (>= max n_i)
    global_rows: int              # sum(rows_per_rank)

    @property
    def num_ranks(self) -> int:
        return len(self.rows_per_rank)


def plan_capacities(
    global_rows: int,
    capacities: Sequence[float],
    buffer_rows: Optional[int] = None,
    min_rows: int = 0,
    headroom: float = 1.0,
    round_buffer_to: int = 1,
) -> CapacityPlan:
    """Largest-remainder proportional allocation of rows to ranks.

    ``buffer_rows`` defaults to the smallest uniform buffer that fits the
    allocation (ceil of the max share), scaled by ``headroom``. Dead
    ranks (capacity 0) get 0 rows.
    """
    caps = np.asarray(capacities, np.float64)
    if caps.ndim != 1 or len(caps) == 0:
        raise ValueError("capacities must be a non-empty 1-D sequence")
    if np.any(caps < 0):
        raise ValueError("capacities must be >= 0")
    total = caps.sum()
    if total <= 0:
        raise ValueError("at least one rank must have capacity > 0")

    share = global_rows * caps / total
    base = np.floor(share).astype(np.int64)
    rem = global_rows - int(base.sum())
    # hand the leftover rows to the largest fractional remainders
    frac_order = np.argsort(-(share - base), kind="stable")
    base[frac_order[:rem]] += 1
    base = np.maximum(base, np.where(caps > 0, min_rows, 0))
    # min_rows may have overshot: trim from the largest allocations
    excess = int(base.sum()) - global_rows
    if excess > 0:
        order = np.argsort(-base, kind="stable")
        for r in order:
            take = min(excess, int(base[r]) - min_rows)
            base[r] -= take
            excess -= take
            if excess == 0:
                break

    need = int(base.max())
    if buffer_rows is None:
        buffer_rows = int(np.ceil(need * headroom))
    if round_buffer_to > 1:
        buffer_rows = -(-buffer_rows // round_buffer_to) * round_buffer_to
    if need > buffer_rows:
        # capacity-constrained: clip and redistribute to ranks with room
        overflow = 0
        for r in range(len(base)):
            if base[r] > buffer_rows:
                overflow += int(base[r]) - buffer_rows
                base[r] = buffer_rows
        for r in np.argsort(-caps, kind="stable"):
            if overflow == 0:
                break
            room = buffer_rows - int(base[r]) if caps[r] > 0 else 0
            take = min(room, overflow)
            base[r] += take
            overflow -= take
        if overflow > 0:
            raise ValueError(
                f"global_rows={global_rows} exceeds total buffer capacity "
                f"{buffer_rows * int((caps > 0).sum())}")

    return CapacityPlan(capacities=caps.astype(np.float32),
                        rows_per_rank=base.astype(np.int64),
                        buffer_rows=int(buffer_rows),
                        global_rows=int(base.sum()))
