"""Deterministic fault injection for live heterogeneity.

The paper's capacity table is static; real heterogeneous fleets drift.
This module scripts that drift as a declarative, seedable *schedule* of
per-rank faults and turns it into the signals the rest of the stack
already consumes:

  * ``slowdown(rank, factor, start, duration)`` — thermal throttling /
    shared tenancy: the rank's modeled step time is multiplied by
    ``factor`` while the window is active.
  * ``kill(rank=..|pod=.., step=..)`` — dead rank or whole-pod loss:
    the victim stops reporting step times from ``step`` on (the
    straggler monitor times it out, soft-replans it to zero rows, or
    escalates ``RemeshRequired`` when the survivors cannot fit the
    global batch).
  * ``flaky(rank, drop_prob, start, duration)`` — a missed step-time
    *report* (monitoring-plane noise, not lost work): with probability
    ``drop_prob`` the rank reports ``None`` for that step.
  * ``ckpt_io_fail(step=.., mode=.., fails=..)`` — transient (or
    persistent) ``OSError`` injected into the checkpoint writer via
    ``ChaosEngine.ckpt_fault_hook`` (exercises the writer's bounded
    retry; ``step=None`` targets every save).

Everything is a pure function of (schedule, seed, step, rank): the
modeled trace replays bit-identically from the seed — flaky drops are
hashed from ``SeedSequence([seed, step, rank])``, never from call
order — so a chaos run is a *reproducible* regression scenario, not a
flaky test.

Port of ``repro/core/chaos.py``: host-side numpy, copied so that the
port does not import the JAX package. Every rank of a multi-process run
builds the same engine and queries it with the same inputs, so every
rank sees the same faults and makes the same decisions; a rank the
schedule kills is modelled, not killed (it keeps taking part in the
collectives until the re-mesh).

Timing model (the driver feeds one measured time a step, the slowest
rank's wall, the same on every rank, so this is where per-rank
differentiation comes from):

  t_r(step) = measured * (n_r / speed_r) / mean_alive(n / speed)
            * slowdown_factor_r(step)

``speed_r`` is the rank's declared relative capacity (the "true"
hardware speed the chaos engine perturbs); the normalization keeps the
mean modeled time equal to the measured host step time. At the replan
fixed point (rows proportional to speed/factor) every rank reports the
same time — the monitor's throughput feed converges instead of
oscillating, and a sustained slowdown settles at rows ∝ 1/factor.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("slowdown", "kill", "flaky", "ckpt_io_fail")
CKPT_FAIL_MODES = ("transient", "persistent")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One declarative fault. Use the module-level constructors
    (:func:`slowdown`, :func:`kill`, :func:`flaky`,
    :func:`ckpt_io_fail`) rather than building these by hand."""

    kind: str
    rank: Optional[int] = None     # slowdown / flaky / kill target
    pod: Optional[int] = None      # kill target (whole pod)
    factor: float = 1.0            # slowdown multiplier (> 1 = slower)
    start: int = 0                 # first affected step (inclusive)
    duration: Optional[int] = None  # steps; None = until the run ends
    drop_prob: float = 0.0         # flaky: P(missed report) per step
    step: Optional[int] = None     # kill / ckpt_io_fail trigger step
    mode: str = "transient"        # ckpt_io_fail: transient|persistent
    fails: int = 2                 # ckpt_io_fail transient: attempts

    def validate(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"valid: {FAULT_KINDS}")
        if self.kind == "slowdown":
            if self.rank is None or self.factor <= 0:
                raise ValueError("slowdown needs rank and factor > 0")
        elif self.kind == "kill":
            if (self.rank is None) == (self.pod is None):
                raise ValueError("kill needs exactly one of rank | pod")
            if self.step is None:
                raise ValueError("kill needs step")
        elif self.kind == "flaky":
            if self.rank is None or not 0.0 <= self.drop_prob <= 1.0:
                raise ValueError("flaky needs rank and drop_prob in "
                                 "[0, 1]")
        elif self.kind == "ckpt_io_fail":
            if self.mode not in CKPT_FAIL_MODES:
                raise ValueError(f"ckpt_io_fail mode {self.mode!r}; "
                                 f"valid: {CKPT_FAIL_MODES}")
            if self.fails < 1:
                raise ValueError("ckpt_io_fail needs fails >= 1")

    def active(self, step: int) -> bool:
        """Whether a windowed fault (slowdown/flaky) covers ``step``."""
        if step < self.start:
            return False
        return self.duration is None or step < self.start + self.duration


def slowdown(rank: int, factor: float, start: int = 0,
             duration: Optional[int] = None) -> Fault:
    return Fault("slowdown", rank=rank, factor=factor, start=start,
                 duration=duration)


def kill(rank: Optional[int] = None, pod: Optional[int] = None,
         step: int = 0) -> Fault:
    return Fault("kill", rank=rank, pod=pod, step=step)


def flaky(rank: int, drop_prob: float, start: int = 0,
          duration: Optional[int] = None) -> Fault:
    return Fault("flaky", rank=rank, drop_prob=drop_prob, start=start,
                 duration=duration)


def ckpt_io_fail(step: Optional[int] = None, mode: str = "transient",
                 fails: int = 2) -> Fault:
    return Fault("ckpt_io_fail", step=step, mode=mode, fails=fails)


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A seedable set of faults. JSON form::

        {"seed": 0, "events": [
          {"kind": "slowdown", "rank": 1, "factor": 3.0,
           "start": 5, "duration": 20},
          {"kind": "kill", "pod": 1, "step": 40}]}
    """

    events: Tuple[Fault, ...] = ()
    seed: int = 0

    def validate(self) -> None:
        for ev in self.events:
            ev.validate()

    def with_events(self, *extra: Fault) -> "ChaosSchedule":
        return dataclasses.replace(self, events=self.events + extra)

    def to_record(self) -> Dict:
        events = []
        for ev in self.events:
            d = {k: v for k, v in dataclasses.asdict(ev).items()
                 if v is not None}
            events.append(d)
        return {"seed": int(self.seed), "events": events}

    @classmethod
    def from_record(cls, record: Dict) -> "ChaosSchedule":
        events = []
        for d in record.get("events", ()):
            known = {f.name for f in dataclasses.fields(Fault)}
            bad = set(d) - known
            if bad:
                raise ValueError(f"unknown fault field(s) {sorted(bad)} "
                                 f"in {d}")
            events.append(Fault(**d))
        sched = cls(events=tuple(events),
                    seed=int(record.get("seed", 0)))
        sched.validate()
        return sched

    def to_json(self) -> str:
        return json.dumps(self.to_record(), indent=1)

    @classmethod
    def from_json(cls, text: str) -> "ChaosSchedule":
        return cls.from_record(json.loads(text))


# ---- presets --------------------------------------------------------------
# Parameterized by the topology (num_ranks, data_per_pod) and run
# length so `--chaos <preset>` works on any mesh. Names are documented
# in the README chaos table and pinned by tests/test_config_docs.py.


def _preset_slowdown(num_ranks, data_per_pod, total_steps):
    victim = 1 % num_ranks
    return (slowdown(victim, factor=4.0,
                     start=max(total_steps // 5, 1)),)


def _preset_dead_rank(num_ranks, data_per_pod, total_steps):
    return (kill(rank=num_ranks - 1, step=max(total_steps // 3, 1)),)


def _preset_pod_kill(num_ranks, data_per_pod, total_steps):
    pods = max(num_ranks // max(data_per_pod, 1), 1)
    return (kill(pod=pods - 1, step=max(total_steps // 2, 1)),)


def _preset_storm(num_ranks, data_per_pod, total_steps):
    pods = max(num_ranks // max(data_per_pod, 1), 1)
    return (slowdown(1 % num_ranks, factor=3.0,
                     start=max(total_steps // 6, 1)),
            flaky(0, drop_prob=0.2, start=0,
                  duration=max(total_steps // 2, 1)),
            kill(pod=pods - 1, step=max(2 * total_steps // 3, 1)),
            ckpt_io_fail(step=None, mode="transient", fails=1))


PRESETS: Dict[str, Callable[[int, int, int], Tuple[Fault, ...]]] = {
    "slowdown": _preset_slowdown,
    "dead-rank": _preset_dead_rank,
    "pod-kill": _preset_pod_kill,
    "storm": _preset_storm,
}


def load_schedule(spec: str, num_ranks: int, data_per_pod: int = 1,
                  total_steps: int = 100, seed: int = 0
                  ) -> ChaosSchedule:
    """Resolve a ``--chaos`` value: a preset name or a schedule.json
    path. Presets are built for THIS topology and run length."""
    if spec in PRESETS:
        sched = ChaosSchedule(
            events=PRESETS[spec](num_ranks, data_per_pod, total_steps),
            seed=seed)
        sched.validate()
        return sched
    if os.path.exists(spec) or spec.endswith(".json"):
        with open(spec) as fh:
            return ChaosSchedule.from_json(fh.read())
    raise ValueError(f"--chaos {spec!r} is neither a schedule.json "
                     f"path nor a preset ({sorted(PRESETS)})")


# ---- engine ---------------------------------------------------------------


class ChaosEngine:
    """Applies a :class:`ChaosSchedule` to a concrete topology.

    Pure per-step queries (``slowdown_factor``, ``killed``,
    ``dropped``) plus the two integration surfaces:
    :meth:`step_times` (feeds ``StragglerMonitor.observe``) and
    :meth:`ckpt_fault_hook` (plugs into ``CheckpointManager``).
    """

    def __init__(self, schedule: ChaosSchedule, num_ranks: int,
                 data_per_pod: int = 1,
                 speeds: Optional[Sequence[float]] = None):
        schedule.validate()
        self.schedule = schedule
        self.num_ranks = int(num_ranks)
        self.data_per_pod = max(int(data_per_pod), 1)
        self.pods = max(self.num_ranks // self.data_per_pod, 1)
        if speeds is None:
            sp = np.ones(self.num_ranks, np.float64)
        else:
            sp = np.asarray(speeds, np.float64)
            if sp.shape != (self.num_ranks,):
                raise ValueError(f"speeds needs {self.num_ranks} "
                                 f"entries, got {sp.shape}")
            # capacity 0 declares a rank drained (0 rows), not
            # infinitely slow — model it at unit speed
            sp = np.where(sp > 0, sp, 1.0)
        self.speeds = sp
        # the checkpoint fault hook's write attempts so far, keyed
        # (ordinal of the ckpt_io_fail event, step): one count for the
        # whole run, carried into the engine of every later world
        self.ckpt_attempts: Dict[Tuple[int, int], int] = {}
        for ev in schedule.events:
            if ev.rank is not None and not 0 <= ev.rank < self.num_ranks:
                raise ValueError(f"fault rank {ev.rank} out of range: "
                                 f"{self.num_ranks} DP rank(s)")
            if ev.pod is not None and not 0 <= ev.pod < self.pods:
                raise ValueError(f"fault pod {ev.pod} out of range: "
                                 f"mesh has {self.pods} pod(s)")

    # ---- per-(step, rank) queries ----------------------------------------

    def _pod(self, rank: int) -> int:
        return rank // self.data_per_pod

    def slowdown_factor(self, step: int, rank: int) -> float:
        f = 1.0
        for ev in self.schedule.events:
            if ev.kind == "slowdown" and ev.rank == rank \
                    and ev.active(step):
                f *= ev.factor
        return f

    def killed(self, step: int, rank: int) -> bool:
        for ev in self.schedule.events:
            if ev.kind != "kill" or step < ev.step:
                continue
            if ev.rank == rank or (ev.pod is not None
                                   and ev.pod == self._pod(rank)):
                return True
        return False

    def dropped(self, step: int, rank: int) -> bool:
        """Flaky missed report — deterministic in (seed, step, rank)."""
        for ev in self.schedule.events:
            if ev.kind != "flaky" or ev.rank != rank \
                    or not ev.active(step):
                continue
            u = np.random.default_rng(np.random.SeedSequence(
                [self.schedule.seed, step, rank])).random()
            if u < ev.drop_prob:
                return True
        return False

    # ---- integration surfaces --------------------------------------------

    def step_times(self, step: int, rows_per_rank: Sequence[int],
                   measured: float) -> List[Optional[float]]:
        """Modeled per-rank step times for ``StragglerMonitor.observe``.

        ``measured`` is the host-clock step time; ``None`` entries are
        killed ranks (dead — no report ever again) and flaky drops
        (this step's report lost).
        """
        rows = np.maximum(np.asarray(rows_per_rank, np.float64), 1.0)
        load = rows / self.speeds                 # per-rank relative work
        norm = measured / float(load.mean())
        out: List[Optional[float]] = []
        for r in range(self.num_ranks):
            if self.killed(step, r) or self.dropped(step, r):
                out.append(None)
            else:
                out.append(norm * load[r] * self.slowdown_factor(step, r))
        return out

    def modeled_step_wall(self, step: int,
                          rows_per_rank: Sequence[int],
                          row_cost: float = 1.0) -> float:
        """Modeled wall-clock of one synchronous step: the max over
        alive ranks of (rows / speed) * slowdown * row_cost. Killed
        ranks drop out (their buffers are all-dummy after the replan;
        before it, their lost work shows up as training-progress loss,
        not wall time). Flaky drops are monitoring noise — the rank
        still does its work."""
        rows = np.maximum(np.asarray(rows_per_rank, np.float64), 1.0)
        load = rows / self.speeds
        wall = 0.0
        for r in range(self.num_ranks):
            if self.killed(step, r):
                continue
            wall = max(wall,
                       row_cost * load[r] * self.slowdown_factor(step, r))
        return wall

    def trace(self, num_steps: int, rows_per_rank: Sequence[int],
              measured: float = 1.0) -> List[Dict]:
        """The full modeled trace — pure function of (schedule, seed,
        topology): two engines built alike produce byte-identical JSON.
        """
        out = []
        for s in range(num_steps):
            out.append({
                "step": s,
                "times": self.step_times(s, rows_per_rank, measured),
                "wall": self.modeled_step_wall(s, rows_per_rank),
            })
        return out

    def ckpt_fault_hook(self) -> Callable[[int, str], None]:
        """A ``CheckpointManager.fault_hook``: raises ``OSError`` for
        scheduled ``ckpt_io_fail`` events. Transient events fail the
        first ``fails`` write attempts of a matching step, then let the
        retry succeed; persistent events fail every attempt. The attempts
        count in :attr:`ckpt_attempts`, which :meth:`after_remesh` hands
        on, so a re-meshed run's new manager fails a transient event's
        step as often in all as the JAX driver's one manager does."""
        attempts = self.ckpt_attempts

        def hook(step: int, path: str) -> None:
            faults = [ev for ev in self.schedule.events
                      if ev.kind == "ckpt_io_fail"]
            for i, ev in enumerate(faults):
                if ev.step is not None and ev.step != step:
                    continue
                n = attempts.get((i, step), 0)
                attempts[(i, step)] = n + 1
                if ev.mode == "persistent" or n < ev.fails:
                    raise OSError(
                        f"chaos: injected ckpt_io_fail "
                        f"({ev.mode}, attempt {n + 1}) at step {step}")
        return hook

    def after_remesh(self, alive_pods: Sequence[int]) -> "ChaosEngine":
        """The engine for the surviving topology: ranks renumbered to
        the new (smaller) mesh, faults on dead pods dropped, global
        faults (``ckpt_io_fail``) kept with their write attempts so far
        (:attr:`ckpt_attempts`). The seed is unchanged — the
        surviving ranks' flaky draws change with their new rank ids,
        which mirrors reality (the re-meshed fleet is a new run)."""
        alive = sorted(set(alive_pods))
        pod_map = {p: i for i, p in enumerate(alive)}

        def map_rank(rank: int) -> Optional[int]:
            p = self._pod(rank)
            if p not in pod_map:
                return None
            return (pod_map[p] * self.data_per_pod
                    + rank % self.data_per_pod)

        events = []
        for ev in self.schedule.events:
            if ev.kind == "ckpt_io_fail":
                events.append(ev)
                continue
            if ev.pod is not None:
                if ev.pod in pod_map:
                    events.append(dataclasses.replace(
                        ev, pod=pod_map[ev.pod]))
                continue
            new_rank = map_rank(ev.rank)
            if new_rank is not None:
                events.append(dataclasses.replace(ev, rank=new_rank))
        speeds = np.concatenate([
            self.speeds[p * self.data_per_pod:(p + 1) * self.data_per_pod]
            for p in alive])
        engine = ChaosEngine(
            dataclasses.replace(self.schedule, events=tuple(events)),
            num_ranks=len(alive) * self.data_per_pod,
            data_per_pod=self.data_per_pod, speeds=speeds)
        # ckpt_io_fail events are kept in order: their ordinals hold
        engine.ckpt_attempts.update(self.ckpt_attempts)
        return engine
