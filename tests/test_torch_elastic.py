"""repro_torch's fault-tolerance loop against the JAX package (CPU).

  (a) the chaos engine (``core/chaos.py``) against JAX's over every
      preset, 1-3 pods x 1-2 ranks a pod and 20 steps: ``killed``,
      ``dropped``, ``slowdown_factor``, ``step_times``,
      ``modeled_step_wall``, ``trace`` and ``after_remesh``, bitwise; a
      schedule's JSON written by either package loads in the other;
  (b) the straggler monitor and the planner: the same observation
      sequences (with missed reports) give the same EMA, dead ranks,
      ``should_replan``, replanned rows and ``RemeshRequired`` step;
      ``replan_from_step_times``, ``plan_remesh`` and
      ``validate_resume_equivalence`` on a grid, errors included
      (bitwise, and the same error message);
  (c) the driver on the CPU: a resume on one rank is bitwise equal to
      the uninterrupted run; two gloo ranks under a chaos slowdown and a
      pod kill replan at the same steps, re-mesh to one pod, scale accum
      x2 and finish; ``--kill-pod`` on one pod fails loudly;
  (d) the re-mesh equality the port gives: two fp32 ranks (plain
      all-reduce) checkpoint at step 2 and go on; the checkpoint
      restored on one rank with accum x2 and the plan from
      ``plan_remesh`` follows the two-rank trajectory to the tolerances
      of ``test_torch_dist_train.py``'s fp32 modes (loss 1e-5 relative,
      grad norm 1e-4, each parameter leaf 1e-4 of its largest
      magnitude), not bitwise: the one rank splits its buffer into
      microbatches of its own (rows 0-1, 2-3, ...), where the two ranks
      each split their own rows, so the gradient sums group the rows
      differently.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro.core import capacity as jcap
from repro.core import chaos as jchaos
from repro.core import elastic as jelastic
from repro.core import straggler as jstraggler
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import base as tcfgs
from repro_torch.core import capacity as tcap
from repro_torch.core import chaos as tchaos
from repro_torch.core import dummy as tdummy
from repro_torch.core import elastic as telastic
from repro_torch.core import straggler as tstraggler
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.transformer import tree_leaves

STEPS = 20
# the fp32 tolerances of test_torch_dist_train.py (the same arithmetic in
# another order)
RTOL, GNORM_RTOL, LEAF_TOL = 1e-5, 1e-4, 1e-4


# --------------------------------------------------------------------------
# (a) the chaos engine
# --------------------------------------------------------------------------


def _speeds(n, seed):
    rng = np.random.default_rng(seed)
    return [float(x) for x in rng.choice([0.0, 0.5, 1.0, 2.0, 3.0], n)]


def _engines(preset, pods, dpp, seed):
    n = pods * dpp
    jsched = jchaos.load_schedule(preset, num_ranks=n, data_per_pod=dpp,
                                  total_steps=STEPS, seed=seed)
    tsched = tchaos.load_schedule(preset, num_ranks=n, data_per_pod=dpp,
                                  total_steps=STEPS, seed=seed)
    assert tsched.to_record() == jsched.to_record()
    speeds = _speeds(n, seed)
    return (jchaos.ChaosEngine(jsched, n, dpp, speeds),
            tchaos.ChaosEngine(tsched, n, dpp, speeds))


def _same_engine(je, te, rows):
    assert te.num_ranks == je.num_ranks and te.pods == je.pods
    np.testing.assert_array_equal(te.speeds, je.speeds)
    for s in range(STEPS):
        for r in range(je.num_ranks):
            assert te.killed(s, r) == je.killed(s, r)
            assert te.dropped(s, r) == je.dropped(s, r)
            assert te.slowdown_factor(s, r) == je.slowdown_factor(s, r)
        measured = 0.1 + 0.01 * s
        assert te.step_times(s, rows, measured) == \
            je.step_times(s, rows, measured)
        assert te.modeled_step_wall(s, rows, 0.3) == \
            je.modeled_step_wall(s, rows, 0.3)
    assert json.dumps(te.trace(STEPS, rows, 0.7)) == \
        json.dumps(je.trace(STEPS, rows, 0.7))


@pytest.mark.parametrize("preset", sorted(jchaos.PRESETS))
def test_chaos_engine_matches_jax_on_every_preset_and_topology(preset):
    assert sorted(tchaos.PRESETS) == sorted(jchaos.PRESETS)
    for pods in (1, 2, 3):
        for dpp in (1, 2):
            seed = 10 * pods + dpp
            je, te = _engines(preset, pods, dpp, seed)
            n = pods * dpp
            rows = list(np.random.default_rng(seed).integers(0, 6, n))
            _same_engine(je, te, rows)
            for alive in ([p for p in range(pods) if p != pods - 1],
                          [p for p in range(pods) if p != 0]):
                if not alive:
                    continue
                ja, ta = je.after_remesh(alive), te.after_remesh(alive)
                assert ta.schedule.to_record() == ja.schedule.to_record()
                _same_engine(ja, ta, rows[:ja.num_ranks])
            # the checkpoint fault hooks raise on the same attempts
            jh, th = je.ckpt_fault_hook(), te.ckpt_fault_hook()
            for step in (0, 3, 3, 3, 7):
                outcome = []
                for hook in (jh, th):
                    try:
                        hook(step, "tmp")
                        outcome.append(None)
                    except OSError as e:
                        outcome.append(str(e))
                assert outcome[0] == outcome[1]


def test_schedule_json_crosses_packages_both_ways(tmp_path):
    events = dict(
        slowdown=dict(rank=1, factor=3.0, start=5, duration=20),
        kill=dict(pod=1, step=40), flaky=dict(rank=0, drop_prob=0.25,
                                              start=0, duration=10),
        ckpt_io_fail=dict(step=12, mode="persistent", fails=1))

    def sched(mod):
        return mod.ChaosSchedule(events=tuple(
            getattr(mod, k)(**v) for k, v in events.items()), seed=7)

    js, ts = sched(jchaos), sched(tchaos)
    assert ts.to_json() == js.to_json()
    assert tchaos.ChaosSchedule.from_json(js.to_json()).to_record() == \
        js.to_record()
    assert jchaos.ChaosSchedule.from_json(ts.to_json()).to_record() == \
        ts.to_record()
    path = tmp_path / "s.json"
    path.write_text(js.to_json())
    assert tchaos.load_schedule(str(path), num_ranks=4).to_record() == \
        js.to_record()
    for mod in (jchaos, tchaos):
        with pytest.raises(ValueError, match="unknown fault field"):
            mod.ChaosSchedule.from_record({"events": [{"kind": "kill",
                                                       "bogus": 1}]})
        with pytest.raises(ValueError, match="neither"):
            mod.load_schedule("no-such-preset", num_ranks=2)


# --------------------------------------------------------------------------
# (b) the monitor and the planner
# --------------------------------------------------------------------------


def _observations(n, steps, seed):
    rng = np.random.default_rng(seed)
    dead_from = {int(r): int(rng.integers(3, steps))
                 for r in rng.choice(n, size=int(rng.integers(0, 2)),
                                     replace=False)}
    out = []
    for s in range(steps):
        row = []
        for r in range(n):
            if s >= dead_from.get(r, steps) or rng.random() < 0.1:
                row.append(None)
            else:
                row.append(float(rng.uniform(0.5, 2.0) * (1 + r)))
        out.append(row)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_straggler_monitor_matches_jax(seed):
    n = 2 + seed % 3
    jplan = jcap.plan_capacities(6 * n, np.ones(n), headroom=1.25)
    tplan = tcap.plan_capacities(6 * n, np.ones(n), headroom=1.25)
    kw = dict(num_ranks=n, ema_decay=0.8, replan_interval=3 + seed % 2)
    jm, tm = jstraggler.StragglerMonitor(**kw), \
        tstraggler.StragglerMonitor(**kw)
    events = []
    for step, obs in enumerate(_observations(n, 25, seed)):
        jm.observe(obs)
        tm.observe(obs)
        np.testing.assert_array_equal(tm.step_time_ema, jm.step_time_ema)
        np.testing.assert_array_equal(tm.dead_ranks(), jm.dead_ranks())
        assert tm.should_replan() == jm.should_replan()
        if not jm.should_replan():
            continue
        try:
            jplan = jm.replan(jplan)
        except jstraggler.RemeshRequired as e:
            with pytest.raises(tstraggler.RemeshRequired) as got:
                tm.replan(tplan)
            assert str(got.value) == str(e)
            events.append(("remesh", step))
            break
        tplan = tm.replan(tplan)
        assert tplan.rows_per_rank.tolist() == jplan.rows_per_rank.tolist()
        assert tplan.buffer_rows == jplan.buffer_rows
        events.append(("replan", step))
    assert events                       # every seed replans at least once
    with pytest.raises(ValueError, match="recreated"):
        tm.observe([1.0] * (n + 1))


def _error_or(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return f"ValueError: {e}"


def _plan_key(p):
    if isinstance(p, str):
        return p
    return (p.capacities.tolist(), p.rows_per_rank.tolist(), p.buffer_rows,
            p.global_rows)


def test_replan_from_step_times_matches_jax():
    inf, nan = float("inf"), float("nan")
    emas = ([1.0, 2.0, 4.0], [0.5, inf, 1.0], [3.0, 3.0, 3.0],
            [1.0, 1e-3, 7.0], [inf, inf, inf], [1.0, nan, 2.0],
            [1.0, 0.0, 2.0], [1.0, -1.0, 2.0], [1.0, 2.0])
    for caps in ((1.0, 1.0, 1.0), (2.0, 1.0, 0.0)):
        for buffer in (None, 12):
            jp = jcap.plan_capacities(24, caps, buffer_rows=buffer,
                                      headroom=1.25)
            tp = tcap.plan_capacities(24, caps, buffer_rows=buffer,
                                      headroom=1.25)
            for ema in emas:
                got = _error_or(tcap.replan_from_step_times, tp,
                                np.asarray(ema))
                want = _error_or(jcap.replan_from_step_times, jp,
                                 np.asarray(ema))
                assert _plan_key(got) == _plan_key(want), (caps, ema)


def test_plan_remesh_and_resume_equivalence_match_jax():
    for pods in (2, 3, 4):
        for dpp in (1, 2):
            for model in (1, 2):
                jt = jelastic.MeshTopology(pods, dpp, model)
                tt = telastic.MeshTopology(pods, dpp, model)
                assert tt.mesh_shape() == jt.mesh_shape()
                assert tt.mesh_axes() == jt.mesh_axes()
                assert tt.dp_size == jt.dp_size
                for alive in (list(range(pods)), list(range(pods - 1)),
                              [pods - 1], [], [0, 0]):
                    for caps in (None, [1.0 + p for p in range(pods)]):
                        for rnd in (1, 2, 3):
                            args = (alive, 12 * pods, caps, rnd)
                            got = _error_or(telastic.plan_remesh, tt, *args)
                            want = _error_or(jelastic.plan_remesh, jt, *args)
                            if isinstance(want, str):
                                assert got == want
                                continue
                            assert (got.restart_required, got.reason,
                                    got.accum_scale, dataclasses.astuple(
                                        got.topology)) == \
                                (want.restart_required, want.reason,
                                 want.accum_scale,
                                 dataclasses.astuple(want.topology))
                            assert _plan_key(got.plan) == \
                                _plan_key(want.plan)
    # resume equivalence, on well-formed and malformed plans alike
    shapes = ([4, 4], [6, 2], [8], [3, 3, 2], [5, 4], [-1, 9], [9, 0])
    for a in shapes:
        for b in shapes:
            for buf in (6, 8, 9):
                pa = (np.ones(len(a)), np.asarray(a), buf, 8)
                pb = (np.ones(len(b)), np.asarray(b), buf, 8)
                assert telastic.validate_resume_equivalence(
                    tcap.CapacityPlan(*pa), tcap.CapacityPlan(*pb)) == \
                    jelastic.validate_resume_equivalence(
                        jcap.CapacityPlan(*pa), jcap.CapacityPlan(*pb))


# --------------------------------------------------------------------------
# (c) the driver on the CPU
# --------------------------------------------------------------------------

DRIVER = ["--arch", "olmo-1b", "--smoke", "--device", "cpu",
          "--global-batch", "8", "--seq-len", "16", "--accum", "2",
          "--lr", "3e-3", "--warmup", "1", "--schedule", "constant",
          "--log-every", "100"]


def test_one_rank_resume_is_bitwise_equal_to_the_uninterrupted_run(
        tmp_path, capsys):
    ck = str(tmp_path / "ck")
    data = ["--data-dir", str(tmp_path / "data")]
    first = ttrain.main(DRIVER + data + ["--steps", "4", "--ckpt-every",
                                         "2", "--ckpt-dir", ck])
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [2, 4]
    for s in (2, 4):
        assert set(mgr.verify(s)["files"]) == {"arrays_host0.npz",
                                               "meta.json"}
    resumed = ttrain.main(DRIVER + data + ["--steps", "6", "--resume",
                                           "--ckpt-every", "2",
                                           "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "resumed from step 4 (epoch 0, batch 4)" in out
    assert mgr.all_steps() == [2, 4, 6]
    whole = ttrain.main(DRIVER + data + ["--steps", "6"])
    assert resumed["steps"] == whole["steps"] == 6
    assert resumed["losses"] == whole["losses"][4:]           # bitwise
    assert first["losses"] == whole["losses"][:4]
    assert resumed["metrics"] == whole["metrics"][4:]
    for a, b in zip(tree_leaves(resumed["state"].params),
                    tree_leaves(whole["state"].params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(resumed["state"].opt.m) +
                    tree_leaves(resumed["state"].opt.v),
                    tree_leaves(whole["state"].opt.m) +
                    tree_leaves(whole["state"].opt.v)):
        assert torch.equal(a, b)
    assert int(resumed["state"].opt.step) == 6
    # nothing left to do: a resume at the budget trains no step
    again = ttrain.main(DRIVER + data + ["--steps", "6", "--resume",
                                         "--ckpt-dir", ck])
    assert again["losses"] == [] and again["steps"] == 6
    assert "nothing to do" in capsys.readouterr().out


def test_two_ranks_replan_together_then_remesh_on_a_pod_kill(tmp_path,
                                                             capsys):
    """Rank 1 runs 4x slow from step 1 (chaos slowdown) and its pod stops
    reporting at step 5: the window replans at steps 2 and 4 move rows
    to rank 0 on both ranks alike; three missed reports later the
    replan cannot fit the global batch in rank 0's buffer, both ranks
    raise RemeshRequired at step 7, and the driver restarts one rank
    from the step-6 checkpoint with accum x2. The step-6 write fails
    twice (chaos ``ckpt_io_fail``) and commits on its third attempt,
    after rank 1 has already returned: the restart must still take step
    6, which only rank 0's joined writer knows."""
    sched = tchaos.ChaosSchedule(events=(
        tchaos.slowdown(1, factor=4.0, start=1), tchaos.kill(pod=1, step=5),
        tchaos.ckpt_io_fail(step=6, mode="transient", fails=2)))
    path = tmp_path / "chaos.json"
    path.write_text(sched.to_json())
    ck = str(tmp_path / "ck")
    out = ttrain.main(DRIVER + [
        "--devices", "2,1,1", "--grad-reduction", "hierarchical",
        "--compression", "int8", "--bucket-mb", "0.05", "--capacities",
        "1,1", "--steps", "10", "--ckpt-every", "2", "--replan-interval",
        "2", "--chaos", str(path), "--ckpt-dir", ck])
    text = capsys.readouterr().out
    assert "remesh:" in text and "re-meshed to" in text, text
    assert "accum_steps scaled x2" in text, text
    first, second = out["worlds"]
    assert first["devices"] == "2,1,1" and second["devices"] == "1,1"
    ranks = first["ranks"]
    assert len(ranks) == 2
    assert ranks[0]["replans"] == ranks[1]["replans"]
    assert [r["step"] for r in ranks[0]["replans"]][:1] == [2]
    assert ranks[0]["replans"][0]["rows"][0] > 4          # rank 0 takes more
    assert ranks[0]["remesh"] == ranks[1]["remesh"]
    rec = ranks[0]["remesh"]
    assert (rec["step"], rec["dead"], rec["checkpoint"]) == (7, [1], 6)
    assert all(r["launches"]["quantize_int8_cuda"] == 0 for r in ranks)
    assert [(w["step"], w["attempts"]) for w in ranks[0]["writes"]] == \
        [(2, 1), (4, 1), (6, 3)]
    resumed = second["ranks"][0]
    assert resumed["start_step"] == 6 and resumed["steps"] == 10
    assert resumed["plan"]["rows_per_rank"] == [8]
    assert out["steps"] == 10 and len(out["losses"]) == 10
    assert out["losses"][:6] == ranks[0]["losses"][:6]
    assert out["losses"][6:] == resumed["losses"]
    assert all(math.isfinite(x) for x in out["losses"])
    assert all(m["weight"] == 8 * 16 for m in out["metrics"])
    # the pre-remesh checkpoints hold both pods' residual, the later ones
    # none (one pod: no int8 exchange)
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [6, 8, 10]
    man = mgr.verify(6)
    assert set(man["files"]) == {"arrays_host0.npz", "arrays_host1.npz",
                                 "meta.json"}
    assert man["hosts"] == 2
    assert mgr.verify(8)["hosts"] == 1


def test_ckpt_fault_attempts_carry_across_a_remesh(tmp_path):
    """A ``ckpt_io_fail`` event's write attempts count once for the whole
    run, as with the JAX driver's one manager. (1) A transient event
    (fails 2) at step 6 whose first attempt fails before a 2 -> 1
    re-mesh: the new world's engine and hook fail one more attempt and
    pass the third, as JAX's single hook does. (2) Through the driver,
    pod 1 lost at step 3 and every save failing once: each world's
    writes commit on their second attempt, and the run's record holds
    the attempts of both worlds (2 a saved step)."""
    def engine(mod):
        return mod.ChaosEngine(mod.ChaosSchedule(events=(
            mod.kill(pod=1, step=3),
            mod.ckpt_io_fail(step=6, mode="transient", fails=2))),
            num_ranks=2)

    je, te = engine(jchaos), engine(tchaos)
    jhook, thook = je.ckpt_fault_hook(), te.ckpt_fault_hook()
    outcomes = ([], [])
    for attempt in range(3):
        if attempt == 1:                # the re-mesh: a new world's hook
            te = te.after_remesh([0])
            thook = te.ckpt_fault_hook()
        for out, hook in zip(outcomes, (jhook, thook)):
            try:
                hook(6, "tmp")
                out.append("ok")
            except OSError as e:
                out.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][2] == "ok" and "attempt 2" in outcomes[1][1]
    assert te.ckpt_attempts == {(0, 6): 3}

    sched = tchaos.ChaosSchedule(events=(
        tchaos.kill(pod=1, step=3),
        tchaos.ckpt_io_fail(step=None, mode="transient", fails=1)))
    path = tmp_path / "chaos.json"
    path.write_text(sched.to_json())
    out = ttrain.main(DRIVER + [
        "--devices", "2,1,1", "--grad-reduction", "hierarchical",
        "--compression", "int8", "--bucket-mb", "0.05", "--capacities",
        "1,1", "--steps", "6", "--ckpt-every", "2", "--replan-interval",
        "2", "--chaos", str(path), "--ckpt-dir", str(tmp_path / "ck")])
    first, second = out["worlds"]
    saved = [w["step"] for world in (first, second)
             for w in world["ranks"][0]["writes"]]
    assert first["ranks"][0]["writes"] and second["ranks"][0]["writes"]
    assert all(w["attempts"] == 2 for world in (first, second)
               for w in world["ranks"][0]["writes"])
    assert out["ckpt_attempts"] == {(0, s): 2 for s in saved}


def test_kill_pod_needs_two_pods_and_dry_run_validates(capsys):
    with pytest.raises(SystemExit, match="two pods or more"):
        ttrain.main(["--smoke", "--device", "cpu", "--kill-pod", "0@3"])
    with pytest.raises(SystemExit, match="out of range"):
        ttrain.main(["--smoke", "--device", "cpu", "--devices", "2,1,1",
                     "--kill-pod", "2@3"])
    with pytest.raises(SystemExit, match="--chaos"):
        ttrain.main(["--smoke", "--device", "cpu", "--chaos", "meteor"])
    # --dry-run: no CUDA needed, nothing trained
    out = ttrain.main(["--smoke", "--dry-run", "--devices", "2,1,1",
                       "--grad-reduction", "hierarchical", "--compression",
                       "int8", "--bucket-mb", "0.05", "--chaos", "storm"])
    assert out == {"steps": 0, "wall_s": 0.0}
    text = capsys.readouterr().out
    assert "dry-run ok: grad_reduction=hierarchical overlap=none " \
           "bucket_mb=0.05 compression=int8 accum=1" in text
    assert "chaos: 4 event(s)" in text
    with pytest.raises(ValueError, match="bucket_mb"):
        ttrain.main(["--smoke", "--dry-run", "--grad-reduction",
                     "bucketed_allreduce"])


# --------------------------------------------------------------------------
# (d) the re-mesh equality
# --------------------------------------------------------------------------

SEQ, GLOBAL, K, STEPS_D = 12, 8, 2, 4
OPT = dict(lr=1e-3, warmup_steps=1, schedule="constant", total_steps=STEPS_D)


def _fp32_tcfg(accum, devices_het):
    mc = dataclasses.replace(tcfgs.smoke_config("olmo-1b"),
                             compute_dtype="float32",
                             attention_impl="kernel")
    return tcfgs.TrainConfig(
        model=mc, shape=tcfgs.ShapeConfig("t", SEQ, GLOBAL, "train"),
        het=tcfgs.HetConfig(accum_steps=accum, **devices_het),
        optimizer=tcfgs.OptimizerConfig(**OPT), label_smoothing=0.1)


def _samples():
    rng = np.random.default_rng(11)
    vocab = tcfgs.smoke_config("olmo-1b").vocab_size
    return [{k: rng.integers(0, vocab, (GLOBAL, SEQ)).astype(np.int32)
             for k in ("inputs", "labels")} for _ in range(STEPS_D)]


def remesh_rank(rank, world, init_method, ck):
    """Two fp32 ranks, plain all-reduce: K steps, a checkpoint, then on
    to STEPS_D; returns each step's metrics and (rank 0) the parameters
    at the end."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager as CM
    mesh_mod.share_cpu(world)
    mesh = mesh_mod.init((2, 1, 1), ("pod", "data", "model"), rank,
                         init_method, "cpu")
    tcfg = _fp32_tcfg(2, {"capacities": (1.0, 1.0)})
    model = tbuild(tcfg.model, "cpu")
    plan = tcap.plan_capacities(GLOBAL, (1.0, 1.0), headroom=1.25,
                                round_buffer_to=2)
    state = tsteps.init_train_state(model, tcfg, mesh=mesh)
    step = tsteps.build_train_step(model, tcfg, mesh)
    b = plan.buffer_rows
    mets = []
    for i, samples in enumerate(_samples()):
        packed = tdummy.pack_global_batch(samples, plan)
        state, met = step(state, {k: torch.from_numpy(
            v[rank * b:(rank + 1) * b]) for k, v in packed.items()})
        mets.append([float(met[k]) for k in ("loss", "grad_norm",
                                             "weight")])
        if i + 1 == K:
            host = tsteps.state_to_host(state, tcfg, mesh)
            if host is not None:
                mgr = CM(ck)
                mgr.save(K, host, meta={
                    "plan": plan, "format": tsteps.checkpoint_format(
                        model, tcfg, mesh)})
                mgr.wait()
    params = ([p.numpy().copy() for p in tree_leaves(state.params)]
              if rank == 0 else None)
    mesh_mod.destroy(mesh)
    return {"metrics": mets, "params": params}


def test_remesh_resume_follows_the_two_rank_run_at_fp32_tolerance(tmp_path):
    ck = str(tmp_path / "ck")
    two = mesh_mod.spawn(remesh_rank, 2, (ck,), timeout_s=300)
    assert two[0]["metrics"] == two[1]["metrics"]
    # the driver's re-mesh: pod 1 lost, the plan of the one pod left
    plan2 = tcap.plan_capacities(GLOBAL, (1.0, 1.0), headroom=1.25,
                                 round_buffer_to=2)
    dec = telastic.plan_remesh(telastic.MeshTopology(2, 1, 1), [0],
                               GLOBAL, [1.0, 1.0], round_buffer_to=2)
    assert dec.accum_scale == 2
    assert telastic.validate_resume_equivalence(plan2, dec.plan)
    tcfg = _fp32_tcfg(2 * dec.accum_scale, {})
    model = tbuild(tcfg.model, "cpu")
    mesh = mesh_mod.local()
    mgr = CheckpointManager(ck)
    host, meta = mgr.restore(tsteps.state_shapes(model, tcfg, mesh))
    assert telastic.validate_resume_equivalence(meta["plan"], dec.plan)
    state = tsteps.state_from_host(host, model, tcfg, mesh)
    step = tsteps.build_train_step(model, tcfg, mesh)
    got = []
    for samples in _samples()[K:]:
        packed = tdummy.pack_global_batch(samples, dec.plan)
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in packed.items()})
        got.append([float(met[k]) for k in ("loss", "grad_norm",
                                            "weight")])
    got, want = np.array(got), np.array(two[0]["metrics"][K:])
    np.testing.assert_array_equal(got[:, 2], want[:, 2])        # weight
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=GNORM_RTOL)
    worst = 0.0
    for a, b in zip(tree_leaves(state.params), two[0]["params"]):
        err = float(np.abs(a.numpy() - b).max() / np.abs(b).max())
        worst = max(worst, err)
        assert err <= LEAF_TOL
    print(f"re-mesh 2->1 after {STEPS_D - K} steps: loss rel "
          f"{np.max(np.abs(got[:, 0] / want[:, 0] - 1)):.2e}, grad norm rel "
          f"{np.max(np.abs(got[:, 1] / want[:, 1] - 1)):.2e}, worst leaf "
          f"{worst:.2e} of its largest; bitwise: "
          f"{bool(np.array_equal(got, want))}")
