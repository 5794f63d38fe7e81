"""Pipeline parallelism core: capacity-sized stages + 1F1B scheduling
(port of ``repro/core/pipeline.py``, numpy only).

HetPipe direction (PAPERS.md): HetSeq absorbs capacity differences only
through batch sizing, which caps the model at what the smallest pod can
hold. Pipelining splits the *layer stack* into contiguous stages sized
by the same per-pod capacity scores the batch planner uses — fast pods
get more layers — so stage times equalise on skewed hardware exactly
like per-rank row counts do in the DP planner.

Reuse contract: the stage partition IS a
:class:`core.capacity.CapacityPlan` — ``plan_capacities(num_layers,
capacities, min_rows=1)`` assigns layers-per-stage by the identical
largest-remainder math, and ``plan_record``/``plan_from_record`` give
the checkpoint round-trip for free. ``stage_record`` is what
``steps.checkpoint_format`` embeds so a checkpoint saved under one
stage partition restores bit-exactly into another (params are stored
per-leaf; only the *placement* changes with the plan).

Scheduling: :func:`stage_schedule` builds per-stage op lists for the
classic 1F1B (warmup / steady 1F1B / drain) or GPipe (all forwards,
then all backwards) orders; :func:`program_order` merges them into ONE
deterministic global sequence by simulating the stages round-robin
under the dependency rules

    F(s, m)  needs  F(s-1, m)
    B(S-1,m) needs  F(S-1, m)
    B(s, m)  needs  B(s+1, m) and F(s, m)

which is the order ``launch/steps.py::_build_pipeline_step`` runs its
per-stage forward and backward segments in (in one process), and the
order in which the stage ranks of a ``pipe`` axis post their
point-to-point hops; the modeled timeline below charges compute in it
too. Backward ops for a fixed stage occur in microbatch order, so
per-leaf gradient accumulation at each B event reproduces
``core/accumulate.py::accumulate_sums``'s add order bit-for-bit.

Everything here is host-side (NumPy / pure python): it runs when the
step is built and between steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import capacity

SCHEDULES = ("1f1b", "gpipe")

# (kind, microbatch) op kinds in per-stage schedules / program orders.
FWD = "F"
BWD = "B"


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Contiguous partition of a uniform layer stack into stages.

    ``plan.rows_per_rank[s]`` is the number of layers owned by stage
    ``s``; stages are contiguous in depth order (stage 0 owns the
    embedding, the last stage owns the head — ``models/transformer.py``'s
    ``pipeline_stage_fns`` contract).
    """

    plan: capacity.CapacityPlan   # rows == layers, ranks == stages
    num_layers: int

    @property
    def num_stages(self) -> int:
        return self.plan.num_ranks

    @property
    def layers_per_stage(self) -> np.ndarray:
        return self.plan.rows_per_rank

    @property
    def boundaries(self) -> np.ndarray:
        """(S+1,) cumulative layer offsets; stage s owns [b[s], b[s+1])."""
        return np.concatenate(
            [[0], np.cumsum(self.layers_per_stage)]).astype(np.int64)

    def stage_ranges(self) -> List[Tuple[int, int]]:
        b = self.boundaries
        return [(int(b[s]), int(b[s + 1])) for s in range(self.num_stages)]

    def stage_of_layer(self, layer: int) -> int:
        if not 0 <= layer < self.num_layers:
            raise ValueError(
                f"layer {layer} outside stack of {self.num_layers}")
        return int(np.searchsorted(self.boundaries, layer, side="right") - 1)


def plan_stages(num_layers: int,
                capacities: Sequence[float]) -> StagePlan:
    """Capacity-sized contiguous stage partition of ``num_layers``.

    Every stage must end up with >= 1 layer: unlike DP ranks, a stage
    cannot run all-dummy (the forward must pass through it), so zero /
    negative capacities and more stages than layers are loud errors —
    drop the dead pod from the pipeline instead.
    """
    caps = np.asarray(capacities, np.float64)
    if caps.ndim != 1 or len(caps) == 0:
        raise ValueError("stage capacities must be a non-empty 1-D sequence")
    if np.any(caps <= 0):
        bad = np.nonzero(caps <= 0)[0].tolist()
        raise ValueError(
            f"stage capacities must be > 0 (stages {bad} are not): a "
            "pipeline stage cannot be all-dummy — remove the dead pod "
            "from the pipe axis instead")
    if num_layers < len(caps):
        raise ValueError(
            f"cannot cut {num_layers} layers into {len(caps)} stages "
            "(every stage needs >= 1 layer)")
    plan = capacity.plan_capacities(
        int(num_layers), caps, buffer_rows=int(num_layers), min_rows=1)
    assert int(plan.rows_per_rank.sum()) == int(num_layers)
    return StagePlan(plan=plan, num_layers=int(num_layers))


def uniform_stages(num_layers: int, num_stages: int) -> StagePlan:
    return plan_stages(num_layers, np.ones(num_stages))


def stage_record(splan: StagePlan) -> dict:
    """JSON-able checkpoint form (round-trips via capacity.plan_record)."""
    return {
        "num_layers": int(splan.num_layers),
        "plan": capacity.plan_record(splan.plan),
    }


def stage_from_record(record: dict) -> StagePlan:
    if not isinstance(record, dict):
        raise ValueError(
            f"malformed stage-plan record: expected dict, got "
            f"{type(record).__name__}")
    try:
        plan = capacity.plan_from_record(record["plan"])
        num_layers = int(record["num_layers"])
    except (KeyError, TypeError) as e:
        raise ValueError(f"malformed stage-plan record: {e!r}") from e
    splan = StagePlan(plan=plan, num_layers=num_layers)
    if int(plan.rows_per_rank.sum()) != num_layers:
        raise ValueError(
            f"malformed stage-plan record: layers_per_stage sums to "
            f"{int(plan.rows_per_rank.sum())}, num_layers={num_layers}")
    return splan


# --------------------------------------------------------------------------
# schedules


def stage_schedule(num_stages: int, num_microbatches: int,
                   schedule: str = "1f1b") -> List[List[Tuple[str, int]]]:
    """Per-stage op lists [(kind, microbatch), ...] in execution order.

    ``1f1b``: stage s runs ``min(M, S-1-s)`` warmup forwards, then
    alternates 1 forward / 1 backward (steady state), then drains the
    remaining backwards. Peak live activations on stage s are bounded
    by ``S - s`` microbatches instead of GPipe's M.

    ``gpipe``: all M forwards, then all M backwards.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r} not in {SCHEDULES}")
    S, M = int(num_stages), int(num_microbatches)
    if S < 1 or M < 1:
        raise ValueError(f"need num_stages >= 1 and num_microbatches >= 1, "
                         f"got {S}, {M}")
    out: List[List[Tuple[str, int]]] = []
    for s in range(S):
        ops: List[Tuple[str, int]] = []
        if schedule == "gpipe":
            ops += [(FWD, m) for m in range(M)]
            ops += [(BWD, m) for m in range(M)]
        else:
            warmup = min(M, S - 1 - s)
            ops += [(FWD, m) for m in range(warmup)]
            f, b = warmup, 0
            while f < M:            # steady 1F1B
                ops.append((FWD, f)); f += 1
                ops.append((BWD, b)); b += 1
            while b < M:            # drain
                ops.append((BWD, b)); b += 1
        out.append(ops)
    return out


def program_order(num_stages: int, num_microbatches: int,
                  schedule: str = "1f1b") -> List[Tuple[int, str, int]]:
    """Deterministic global [(stage, kind, microbatch), ...] order.

    Round-robin simulation: sweep the stages, each issuing its next
    scheduled op iff its dependencies have already been issued. Raises
    if the schedule deadlocks (cross-check on stage_schedule).
    """
    per_stage = stage_schedule(num_stages, num_microbatches, schedule)
    S = int(num_stages)
    ptr = [0] * S
    done = set()
    order: List[Tuple[int, str, int]] = []

    def ready(s: int, kind: str, m: int) -> bool:
        if kind == FWD:
            return s == 0 or (s - 1, FWD, m) in done
        if s == S - 1:
            return (s, FWD, m) in done
        return (s + 1, BWD, m) in done and (s, FWD, m) in done

    remaining = sum(len(ops) for ops in per_stage)
    while remaining:
        progressed = False
        for s in range(S):
            if ptr[s] >= len(per_stage[s]):
                continue
            kind, m = per_stage[s][ptr[s]]
            if ready(s, kind, m):
                order.append((s, kind, m))
                done.add((s, kind, m))
                ptr[s] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            stuck = {s: per_stage[s][ptr[s]] for s in range(S)
                     if ptr[s] < len(per_stage[s])}
            raise ValueError(f"schedule deadlock: {stuck}")
    return order


# --------------------------------------------------------------------------
# modeled step times (host-side; the JAX package's pipeline benchmark's
# constants)


def modeled_pipeline_step_time(
    splan: StagePlan,
    speeds: Sequence[float],
    *,
    num_microbatches: int,
    mb_rows: int,
    row_layer_time: float,
    act_bytes_per_mb: float,
    dcn_bytes_per_s: float,
    bwd_mult: float = 2.0,
    schedule: str = "1f1b",
) -> float:
    """Event-driven makespan of one pipelined step (seconds).

    Per-microbatch stage compute: ``mb_rows * layers_s * row_layer_time
    / speeds[s]`` forward, ``bwd_mult``x that backward. Stage boundary
    traffic (activation forward + cotangent backward) is charged to the
    sending op at DCN rate. Ops run serially per stage in schedule
    order; cross-stage dependencies follow :func:`program_order`.
    """
    speeds = np.asarray(speeds, np.float64)
    S = splan.num_stages
    if len(speeds) != S:
        raise ValueError(f"{len(speeds)} speeds for {S} stages")
    layers = splan.layers_per_stage.astype(np.float64)
    send = act_bytes_per_mb / dcn_bytes_per_s
    t_f = mb_rows * layers * row_layer_time / speeds
    t_f = t_f + np.where(np.arange(S) < S - 1, send, 0.0)   # F send to s+1
    t_b = bwd_mult * mb_rows * layers * row_layer_time / speeds
    t_b = t_b + np.where(np.arange(S) > 0, send, 0.0)       # B send to s-1

    avail = np.zeros(S)
    done: Dict[Tuple[int, str, int], float] = {}
    for (s, kind, m) in program_order(S, num_microbatches, schedule):
        if kind == FWD:
            dep = done.get((s - 1, FWD, m), 0.0) if s > 0 else 0.0
            dur = float(t_f[s])
        else:
            dep = (done[(s, FWD, m)] if s == S - 1
                   else max(done[(s + 1, BWD, m)], done[(s, FWD, m)]))
            dur = float(t_b[s])
        start = max(float(avail[s]), dep)
        done[(s, kind, m)] = start + dur
        avail[s] = start + dur
    return max(done.values())


def modeled_dp_step_time(
    num_layers: int,
    capacities: Sequence[float],
    *,
    global_rows: int,
    row_layer_time: float,
    param_bytes_per_layer: float,
    dcn_bytes_per_s: float,
    bwd_mult: float = 2.0,
) -> float:
    """Pure-DP baseline on the same pods: capacity-sized batch shares.

    Every rank computes the FULL stack over its row share (rows from
    the same largest-remainder planner) and then syncs the FULL
    gradient over DCN — the term pipelining removes by exchanging only
    stage-boundary activations instead.
    """
    plan = capacity.plan_capacities(int(global_rows), capacities)
    speeds = np.asarray(capacities, np.float64)
    rows = plan.rows_per_rank.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_rank = np.where(
            speeds > 0,
            rows * num_layers * row_layer_time * (1.0 + bwd_mult) / speeds,
            0.0)
    sync = num_layers * param_bytes_per_layer / dcn_bytes_per_s
    return float(per_rank.max()) + sync
