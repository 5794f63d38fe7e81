"""Elastic scaling: re-mesh on membership change, exact-resume semantics.

Two regimes, in escalation order:

1. **Soft degradation (no restart)** — a rank dies mid-window: the
   straggler monitor marks it dead, the capacity planner assigns it 0
   rows (all-dummy buffer, weight 0). SPMD shapes are unchanged, the
   dead rank's host is expected to keep participating in collectives
   (TPU slices fail whole-slice in practice, which is regime 2); for the
   multi-pod DCN case a lost *pod* is regime 2.

2. **Re-mesh restart** — membership changed durably (pod lost/added):
   reload the latest checkpoint, rebuild the mesh with the new DP width,
   and re-plan capacities. Because data order derives from
   (seed, epoch, global_step) — never from rank count — and aggregation
   divides by summed weight, the *global* sample stream and the loss
   are identical across any re-mesh: training resumes exactly. The
   checkpoint side holds up its end: v3 saves are per-host shard files
   behind a checksummed manifest (node loss is the common case, so a
   half-written or bit-rotted step is *rejected* and restore falls back
   to the previous committed one), packed optimizer state repacks into
   the new mesh's bucket grid, and the summed int8 error-feedback
   residual is distributed over the new ranks' stream extents — sum
   conserved, no rank restarts carrying the whole fleet's residual
   (checkpoint/checkpoint.py, checkpoint/repack.py).

This module computes the re-mesh decision + new configuration; the
driver (launch/train.py) performs reload/rebuild: the ranks of the old
world return, and the driver spawns the new world, whose ranks restore
the latest checkpoint.

Port of ``repro/core/elastic.py`` (host-side numpy, copied so that the
port does not import the JAX package). One difference of result: the
port's re-meshed rank splits its own buffer into microbatches instead of
keeping the old ranks' grid, so the resumed trajectory equals the
uninterrupted one to fp32 summation order, not bitwise
(``tests/test_torch_elastic.py`` states the tolerance).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.capacity import CapacityPlan, plan_capacities


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Logical description of the available hardware."""

    pods: int
    data_per_pod: int
    model: int

    @property
    def dp_size(self) -> int:
        return self.pods * self.data_per_pod

    def mesh_shape(self) -> Tuple[int, ...]:
        if self.pods > 1:
            return (self.pods, self.data_per_pod, self.model)
        return (self.data_per_pod, self.model)

    def mesh_axes(self) -> Tuple[str, ...]:
        if self.pods > 1:
            return ("pod", "data", "model")
        return ("data", "model")


@dataclasses.dataclass(frozen=True)
class RemeshDecision:
    restart_required: bool
    topology: MeshTopology
    plan: CapacityPlan
    reason: str
    # Multiply HetConfig.accum_steps by this on restart to preserve the
    # per-microbatch grid across the DP-width change: the grad the new
    # mesh accumulates then sums the SAME per-microbatch partials in the
    # SAME association order the old mesh's cross-rank psum used (in the
    # JAX package; the port keeps the microbatch count, not the grouping,
    # so its equality holds to fp32 summation order). 1 when the old DP
    # width does not divide evenly.
    accum_scale: int = 1


def plan_remesh(
    current: MeshTopology,
    alive_pods: Sequence[int],
    global_rows: int,
    capacities_per_pod: Optional[Sequence[float]] = None,
    round_buffer_to: int = 1,
) -> RemeshDecision:
    """Decide how to continue after a membership change.

    ``alive_pods``: indices of pods still healthy. If all pods are alive
    this is a no-op (soft path handles intra-pod stragglers). Otherwise
    rebuild with the surviving pods and re-plan the same global batch
    over the smaller DP width — per-rank buffers grow, weights stay
    exact, the optimizer trajectory is unchanged. ``round_buffer_to``
    (pass the CURRENT accum_steps) keeps the new buffer divisible into
    microbatches: the returned plan's buffer divides by
    ``round_buffer_to * accum_scale``, matching the post-scale
    accum_steps the caller applies on restart.
    """
    alive = sorted(set(alive_pods))
    if len(alive) == current.pods:
        plan = plan_capacities(
            global_rows,
            np.repeat(np.asarray(capacities_per_pod, np.float64),
                      current.data_per_pod)
            if capacities_per_pod is not None
            else np.ones(current.dp_size),
            round_buffer_to=round_buffer_to)
        return RemeshDecision(False, current, plan, "membership unchanged")
    if not alive:
        raise ValueError("no pods alive")
    new_topo = MeshTopology(pods=len(alive),
                            data_per_pod=current.data_per_pod,
                            model=current.model)
    caps = (np.asarray([capacities_per_pod[p] for p in alive], np.float64)
            if capacities_per_pod is not None else np.ones(len(alive)))
    accum_scale = (current.dp_size // new_topo.dp_size
                   if current.dp_size % new_topo.dp_size == 0 else 1)
    # the caller multiplies accum_steps by accum_scale on restart, so
    # the buffer must divide by the PRODUCT (a max() would leave e.g.
    # accum 2 x scale 2 = 4 microbatches over a buffer rounded to 2)
    plan = plan_capacities(global_rows,
                           np.repeat(caps, new_topo.data_per_pod),
                           round_buffer_to=(max(round_buffer_to, 1) *
                                            accum_scale))
    return RemeshDecision(
        True, new_topo, plan,
        f"pods {sorted(set(range(current.pods)) - set(alive))} lost; "
        f"re-mesh to {new_topo.mesh_shape()} and resume from checkpoint",
        accum_scale=accum_scale)


def validate_resume_equivalence(plan_a: CapacityPlan, plan_b: CapacityPlan
                                ) -> bool:
    """Two plans consume the same global record stream (exact resume).

    Comparing ``global_rows`` alone passes plans that consume
    *different* record streams: the sampler hands rank *r* the rows
    ``[sum(n_<r), sum(n_<=r))`` of each global batch, so the invariant
    is about the consumed-row assignment — each plan's
    capacity-normalized per-rank rows must sum to (partition) the same
    global prefix ``[0, global_rows)``, with every rank's slice
    actually fitting its buffer. A plan whose rows over- or under-cover
    the prefix (negative rows, rows past the buffer, sum != global)
    would silently drop or duplicate records on resume. Rank COUNT may
    differ — that is the elastic point; coverage may not.
    """
    def covers_prefix(plan: CapacityPlan) -> bool:
        rows = np.asarray(plan.rows_per_rank, np.int64)
        return (rows.size > 0
                and int(rows.min()) >= 0
                and int(rows.max()) <= plan.buffer_rows
                and int(rows.sum()) == plan.global_rows)

    return (covers_prefix(plan_a) and covers_prefix(plan_b)
            and plan_a.global_rows == plan_b.global_rows)
