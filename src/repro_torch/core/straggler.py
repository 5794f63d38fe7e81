"""Straggler mitigation: per-rank step-time EMA -> capacity replanning.

The paper sets per-node batch sizes statically from memory capacity.
Real heterogeneous fleets drift (thermal throttling, shared tenancy,
failing HBM): we track an EMA of each DP rank's step time and, every
``replan_interval`` steps, re-run the capacity planner with measured
throughput (rows/sec) as the capacity score — slow ranks shed real rows
to fast ranks; the weighted aggregation keeps the math exact through any
replan. A rank that stops reporting (timeout) is treated as dead:
capacity 0, all-dummy buffer, zero weight — training continues without
it until the elastic controller re-meshes (elastic.py).

Host-side numpy, run between steps on every rank with the same inputs
(port of ``repro/core/straggler.py``, copied so that the port does not
import the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.capacity import CapacityPlan, plan_capacities


class RemeshRequired(RuntimeError):
    """Soft replanning cannot absorb the change with fixed SPMD shapes
    (e.g. the surviving buffers no longer fit the global batch) —
    escalate to the elastic controller (elastic.py, checkpoint restart).
    """


@dataclasses.dataclass
class StragglerMonitor:
    num_ranks: int
    ema_decay: float = 0.9
    replan_interval: int = 100
    dead_timeout_steps: int = 3
    _ema: Optional[np.ndarray] = None
    _missed: Optional[np.ndarray] = None
    _steps: int = 0
    _dead_handled: frozenset = frozenset()

    def __post_init__(self):
        self._ema = np.zeros(self.num_ranks, np.float64)
        self._missed = np.zeros(self.num_ranks, np.int64)

    @property
    def step_time_ema(self) -> np.ndarray:
        return self._ema.copy()

    def observe(self, step_times: Sequence[Optional[float]]) -> None:
        """Record one step's per-rank times; None = no report (missed)."""
        if len(step_times) != self.num_ranks:
            raise ValueError(
                f"observe() got {len(step_times)} step times for "
                f"{self.num_ranks} ranks — after an elastic re-mesh the "
                f"monitor must be recreated for the new mesh width")
        self._steps += 1
        for r, t in enumerate(step_times):
            if t is None:
                self._missed[r] += 1
                continue
            self._missed[r] = 0
            if self._ema[r] == 0.0:
                self._ema[r] = t
            else:
                self._ema[r] = (self.ema_decay * self._ema[r] +
                                (1.0 - self.ema_decay) * t)

    def dead_ranks(self) -> np.ndarray:
        return np.flatnonzero(self._missed >= self.dead_timeout_steps)

    def should_replan(self) -> bool:
        """Window boundary — or IMMEDIATELY on a newly-dead rank: a rank
        dying at step ``k*interval + 1`` must not drag all-dummy steps
        for the rest of the window."""
        if set(self.dead_ranks().tolist()) - self._dead_handled:
            return True
        return self._steps > 0 and self._steps % self.replan_interval == 0

    def replan(self, plan: CapacityPlan) -> CapacityPlan:
        """New plan from measured throughput; dead ranks get capacity 0.

        Raises :class:`RemeshRequired` when the global batch no longer
        fits the surviving fixed-size buffers — the caller must escalate
        to elastic.plan_remesh (checkpoint restart with a new mesh).
        """
        self._dead_handled = frozenset(self.dead_ranks().tolist())
        rows = np.maximum(plan.rows_per_rank.astype(np.float64), 1.0)
        ema = np.where(self._ema > 0, self._ema, np.inf)
        throughput = np.where(np.isfinite(ema), rows / ema, 0.0)
        if not throughput.any():
            throughput = np.ones(self.num_ranks)
        throughput[self.dead_ranks()] = 0.0
        try:
            return plan_capacities(plan.global_rows, throughput,
                                   buffer_rows=plan.buffer_rows)
        except ValueError as e:
            raise RemeshRequired(str(e)) from e
