"""Capacity-aware request routing across heterogeneous pods
(copy of ``repro/serve/router.py``).

HetSeq's training-side answer to heterogeneity is a CapacityPlan: rows
per rank proportional to measured speed. Serving reuses the exact same
planner as an *admission weight table* — ``plan_capacities(decode_slots,
pod_speeds)`` yields per-pod concurrency limits summing to the decode
batch, so a pod at half speed holds half the concurrent sequences and
the modeled per-iteration decode time max_p(active_p / speed_p) stays
balanced (Poplar's throughput-proportional load assignment, PAPERS.md).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.core import capacity


class CapacityRouter:
    """Assign each request a pod, bounded by CapacityPlan row limits."""

    def __init__(self, decode_slots: int, pod_speeds: Sequence[float]):
        if decode_slots <= 0:
            raise ValueError(f"decode_slots must be positive, got "
                             f"{decode_slots}")
        self.pod_speeds = tuple(float(s) for s in pod_speeds)
        self.plan = capacity.plan_capacities(decode_slots,
                                             self.pod_speeds)
        if sum(self.plan.rows_per_rank) == 0:
            raise ValueError(
                f"pod speeds {self.pod_speeds} plan to zero concurrency")

    @property
    def num_pods(self) -> int:
        return self.plan.num_ranks

    @property
    def limits(self) -> Tuple[int, ...]:
        """Max concurrent sequences per pod (rows ∝ capacity score)."""
        return self.plan.rows_per_rank

    def route(self, active_per_pod: Sequence[int]) -> Optional[int]:
        """Pick the pod with the most free weighted headroom.

        Returns None when every pod is at its limit. Headroom is
        normalized by the limit so a 2-slot slow pod at 1 active is as
        "full" as an 8-slot fast pod at 4 — absolute headroom would
        funnel every burst to the fast pod and idle the slow one.
        """
        best, best_key = None, None
        for p, (limit, active) in enumerate(zip(self.limits,
                                                active_per_pod)):
            if active >= limit or limit == 0:
                continue
            key = ((limit - active) / limit, self.pod_speeds[p])
            if best_key is None or key > best_key:
                best, best_key = p, key
        return best
