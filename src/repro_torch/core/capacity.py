"""Capacity planner for heterogeneous ranks (port of ``repro/core/capacity.py``).

:class:`CapacityPlan`, :func:`plan_capacities` (the largest-remainder
allocation of rows to ranks in proportion to their capacity scores;
remaining buffer rows become weight-0 dummies), :func:`homogeneous_plan`
and the plan record of checkpoints. Host-side numpy, copied so that the
port does not import the JAX package. ``replan_from_step_times`` comes
with the straggler monitor.
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

    @property
    def padded_rows(self) -> int:
        return self.num_ranks * self.buffer_rows

    def row_weights(self) -> np.ndarray:
        """(R, buffer_rows) 1.0 for real rows, 0.0 for dummy rows."""
        w = np.zeros((self.num_ranks, self.buffer_rows), np.float32)
        for r, n in enumerate(self.rows_per_rank):
            w[r, :n] = 1.0
        return w

    def efficiency(self) -> float:
        """Fraction of buffer slots holding real rows (1.0 = homogeneous)."""
        return float(self.global_rows) / float(self.padded_rows)


def plan_record(plan: CapacityPlan) -> dict:
    """JSON-able form of a plan; :func:`plan_from_record` inverts it."""
    return {
        "capacities": [float(c) for c in plan.capacities],
        "rows_per_rank": [int(r) for r in plan.rows_per_rank],
        "buffer_rows": int(plan.buffer_rows),
        "global_rows": int(plan.global_rows),
    }


def plan_from_record(record: dict) -> CapacityPlan:
    return CapacityPlan(
        capacities=np.asarray(record["capacities"], np.float32),
        rows_per_rank=np.asarray(record["rows_per_rank"], np.int64),
        buffer_rows=int(record["buffer_rows"]),
        global_rows=int(record["global_rows"]))


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


def homogeneous_plan(global_rows: int, num_ranks: int,
                     headroom: float = 1.0) -> CapacityPlan:
    return plan_capacities(global_rows, np.ones(num_ranks),
                           headroom=headroom)
