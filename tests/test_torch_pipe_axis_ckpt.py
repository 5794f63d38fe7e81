"""repro_torch's fault-tolerance loop on the ``pipe`` mesh axis (CPU, gloo):
checkpoints, ``--resume``, chaos and the elastic re-mesh on stage ranks.

  (1) the stage split of the state, without spawning: every stage's
      part (``stage_state_leaves`` of its ``stage_params`` and the
      moments of its ``owned_params``) copied into its slots of one host
      state (``host_state_slots``), as rank 0's gather does, is leaf for
      leaf the one-process pipelined state's ``state_to_host``; and
      ``state_from_host`` under another cut gives each stage exactly its
      ``stage_params`` and owned moments (tied olmo-1b and untied
      tinyllama-1.1b, AdamW and LAMB, cut [3, 1] saved, [2, 2] restored);
  (2) through ``launch/train.py::main``, olmo-1b's smoke config at 4
      layers, every pipe-axis run against the same command without
      ``--pipe-axis`` (every stage in each rank's process):
      (a) each checkpoint's format block, manifest key records and every
          array bitwise equal;
      (b) JAX's ``CheckpointManager`` with JAX's ``state_shapes`` of the
          same pipelined config reads a pipe-axis checkpoint (its
          ``pipeline`` record checked), every leaf bitwise the
          one-process checkpoint's;
      (c) ``--resume`` on the pipe axis: losses and model checksum
          bitwise the uninterrupted pipe-axis run's;
      (d) a pipe-axis checkpoint resumed without the axis, and one
          written without it resumed on it, likewise;
      (e) ``--devices 2,1,1 --capacities 2,1 --global-batch 16
          --kill-pod 1@3`` (four stage ranks): the cut [3, 1] (at
          global batch 8 every unequal pair of capacities leaves pod 0 a
          buffer that absorbs pod 1's rows, so no re-mesh happens; at 16
          capacities 3,1 still do, 2,1 do not), the re-mesh to one pod
          of two stage ranks on the uniform cut [2, 2] with the change
          logged, and losses and model checksum bitwise the run's
          without the axis;
      (f) ``--chaos slowdown`` on four stage ranks: the replans and
          losses of the run without the axis;
  (1') the checkpoint reader maps a large stored member copy-on-write
      (a stage's restore brings in only its part's pages): every array
      as ``np.load`` gives it, a write to one leaves the file alone;
  (3) a restore on two stage ranks, then one step, against JAX's
      ``build_train_step`` on the same checkpoint restored by JAX's
      manager (one device, in this process), at
      ``test_torch_pipeline.py``'s tolerances: loss 1e-5 relative, grad
      norm 1e-4, weight exact, each leaf within 1e-4 of its largest
      magnitude but at most one element in 10,000, that one within 1e-3.
"""
import contextlib
import dataclasses
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro import compat
from repro.checkpoint import checkpoint as jckpt
from repro.checkpoint import repack as jrepack
from repro.configs import base as jcfgs
from repro.launch import steps as jsteps
from repro.launch.sharding import named
from repro.models.model import build_model as jbuild
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.checkpoint import repack as trepack
from repro_torch.configs import base as tcfgs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.model import build_model as tbuild
from repro_torch.optim import adam as tadam

SEQ, GLOBAL, LAYERS = 12, 8, 4
ARCH = "olmo-1b-l4"
tcfgs.register(ARCH, *(lambda get=get: dataclasses.replace(
    get("olmo-1b"), num_layers=LAYERS) for get in (tcfgs.resolve,
                                                   tcfgs.smoke_config)))
RTOL, GNORM_RTOL, LEAF_TOL, OUTLIER_TOL = 1e-5, 1e-4, 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(state):
    return {k: np.asarray(v) for k, v in
            trepack.flatten_with_paths(state).items()}


def _bitwise(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


# --------------------------------------------------------------------------
# (1) the stage split, without spawning
# --------------------------------------------------------------------------


def _split_cfgs(arch, opt, caps):
    tc = dataclasses.replace(tcfgs.smoke_config(arch), num_layers=LAYERS,
                             compute_dtype="float32", scan_layers=False,
                             attention_impl="kernel")
    return tc, tcfgs.TrainConfig(
        model=tc, shape=tcfgs.ShapeConfig("t", SEQ, GLOBAL, "train"),
        het=tcfgs.HetConfig(pipeline_stages=2, accum_steps=2,
                            capacities=caps),
        optimizer=tcfgs.OptimizerConfig(name=opt, lr=1e-2, warmup_steps=1,
                                        schedule="constant"))


def _batches(vocab, rows, n, seed):
    rng = np.random.default_rng(seed)
    return [{"inputs": torch.from_numpy(rng.integers(
                 0, vocab, (rows, SEQ)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(
                 0, vocab, (rows, SEQ)).astype(np.int32)),
             "weights": torch.from_numpy(
                 (rng.random((rows, SEQ)) > 0.2).astype(np.float32))}
            for _ in range(n)]


def _same_tree(got, want):
    assert isinstance(got, type(want))
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("arch,opt", [("olmo-1b", "adamw"),
                                      ("olmo-1b", "lamb"),
                                      ("tinyllama-1.1b", "adamw"),
                                      ("tinyllama-1.1b", "lamb")])
def test_stage_split_both_ways_matches_the_one_process_state(arch, opt):
    tc, tcfg = _split_cfgs(arch, opt, (3.0, 1.0))
    model = tbuild(tc, "cpu")
    one = mesh_mod.local(device="cpu")
    state = tsteps.init_train_state(model, tcfg, mesh=one)
    step = tsteps.build_train_step(model, tcfg, one)
    for b in _batches(tc.vocab_size, 4, 2, seed=3):
        state, _ = step(state, b)
    want = tsteps.state_to_host(state, tcfg, one)
    splan = tsteps.stage_plan_for(model, tcfg)
    assert splan.layers_per_stage.tolist() == [3, 1]

    # every stage's part, as a stage rank holds it, into its slots
    host = tsteps.empty_host_state(tc, tcfg.optimizer)
    for s in range(2):
        held = tsteps.stage_params(state.params, tc, splan, s)
        part = tsteps.TrainState(params=held, opt=tadam.AdamState(
            step=state.opt.step,
            m=tsteps.owned_params(tsteps.stage_params(
                state.opt.m, tc, splan, s), tc, splan, s),
            v=tsteps.owned_params(tsteps.stage_params(
                state.opt.v, tc, splan, s), tc, splan, s)), err=())
        slots = tsteps.host_state_slots(host, tc, splan, s)
        leaves = tsteps.stage_state_leaves(part, tc, splan, s)
        assert len(slots) == len(leaves) > 0
        for dst, t in zip(slots, leaves):
            dst.copy_(t)
    host = host._replace(opt=host.opt._replace(step=want.opt.step))
    _bitwise(_flat(host), _flat(want))

    # restored into the uniform cut on two stage ranks
    _, uniform = _split_cfgs(arch, opt, ())
    cut = tsteps.stage_plan_for(model, uniform)
    assert cut.layers_per_stage.tolist() == [2, 2]
    staged = mesh_mod.unjoined((2, 1, 1), ("pipe", "data", "model"))
    for s in range(2):
        staged.rank = s
        got = tsteps.state_from_host(want, model, uniform, staged)
        held = tsteps.stage_params(state.params, tc, cut, s)
        _same_tree(got.params, held)
        for mine, full in ((got.opt.m, state.opt.m),
                           (got.opt.v, state.opt.v)):
            _same_tree(mine, tsteps.owned_params(tsteps.stage_params(
                full, tc, cut, s), tc, cut, s))
        assert int(got.opt.step) == 2 and got.err == ()
        # a tied table on stage 0: the parameter copy, no moments
        assert ("embed" in got.opt.m) == (s == (1 if tc.tie_embeddings
                                                else 0))


@pytest.mark.parametrize("map_bytes", [1, 1 << 20])
def test_the_mapped_reader_gives_what_np_load_gives(tmp_path, monkeypatch,
                                                    map_bytes):
    """The reader maps a stored member of ``_MAP_BYTES`` or more
    copy-on-write (every member at 1 byte; at the default 1 MiB the two
    large ones): each array as ``np.load`` gives it, C and Fortran
    order, 0-d and empty; writing one leaves the file as it was; a
    restore through it is bitwise."""
    monkeypatch.setattr(tckpt, "_MAP_BYTES", map_bytes)
    rng = np.random.default_rng(5)
    state = {"params": {"big": rng.random((600, 512), dtype=np.float32),
                        "f": np.asfortranarray(rng.random((300, 700))),
                        "small": rng.random((3, 4)),
                        "empty": np.zeros((0, 3)),
                        "scalar": np.asarray(np.int32(7))}}
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    mgr.wait()
    shard = str(tmp_path / "step_0000000001" / "arrays_host0.npz")
    got, want = tckpt._read_npz(shard), dict(np.load(shard))
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k
        assert isinstance(got[k], np.memmap) == (w.nbytes >= map_bytes), k
    big = got["params/big"]
    big[0, 0] = -1.0
    assert np.load(shard)["params/big"][0, 0] == state["params"]["big"][0, 0]
    tpl = {"params": {k: trepack.ShapeDtype(v.shape, v.dtype)
                      for k, v in state["params"].items()}}
    restored, _ = mgr.restore(tpl)
    _bitwise(_flat(restored), _flat(state))


# --------------------------------------------------------------------------
# (2) the driver
# --------------------------------------------------------------------------

DRIVER = ["--arch", ARCH, "--smoke", "--device", "cpu",
          "--pipeline-stages", "2", "--no-scan-layers", "--accum", "2",
          "--seq-len", "16", "--lr", "3e-3", "--warmup", "1", "--schedule",
          "constant", "--log-every", "100"]
RESUME = ["--devices", "1,1", "--global-batch", "8", "--steps", "6"]
REMESH = ["--devices", "2,1,1", "--capacities", "2,1", "--global-batch",
          "16", "--steps", "6", "--ckpt-every", "2", "--kill-pod", "1@3"]
CHAOS = ["--devices", "2,1", "--global-batch", "8", "--steps", "5",
         "--chaos", "slowdown", "--replan-interval", "4"]


def _logged(argv, path):
    """``main(argv)`` and what it printed, its spawned ranks' lines too
    (they write to the inherited file descriptor 1)."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w+") as f, contextlib.redirect_stdout(f):
        os.dup2(f.fileno(), 1)
        try:
            out = ttrain.main(argv)
        finally:
            f.flush()
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        return out, f.read()


def _without_step(src, dst, step):
    shutil.copytree(src, dst)
    shutil.rmtree(dst / f"step_{step:010d}")
    return str(dst)


@pytest.fixture(scope="module")
def resume_runs(tmp_path_factory):
    """A: six pipe-axis steps with checkpoints at 2, 4, 6; B: the same
    without the axis; from each run's step-4 checkpoint: C the pipe axis
    from A's, D1 no axis from A's, D2 the pipe axis from B's."""
    root = tmp_path_factory.mktemp("resume")
    data = ["--data-dir", str(root / "data")]
    runs = {}
    for name, extra in (("A", ["--pipe-axis"]), ("B", [])):
        runs[name] = ttrain.main(DRIVER + RESUME + data + extra + [
            "--ckpt-every", "2", "--ckpt-dir", str(root / name)])
    a4 = _without_step(root / "A", root / "A4", 6)
    b4 = _without_step(root / "B", root / "B4", 6)
    for name, ck, extra in (("C", a4, ["--pipe-axis"]), ("D1", a4, []),
                            ("D2", b4, ["--pipe-axis"])):
        runs[name] = ttrain.main(DRIVER + RESUME + data + extra + [
            "--resume", "--ckpt-dir", ck])
    return root, runs


@pytest.fixture(scope="module")
def remesh_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("remesh")
    runs = {}
    for name, extra in (("pipe", ["--pipe-axis"]), ("flat", [])):
        runs[name] = _logged(DRIVER + REMESH + extra + [
            "--ckpt-dir", str(root / name), "--data-dir",
            str(root / "data")], root / f"{name}.log")
    return root, runs


def _checkpoints_equal(a, b):
    ma, mb = tckpt.CheckpointManager(str(a)), tckpt.CheckpointManager(str(b))
    steps = ma.all_steps()
    assert steps and steps == mb.all_steps()
    for s in steps:
        da, db = a / f"step_{s:010d}", b / f"step_{s:010d}"
        fa = json.loads((da / "meta.json").read_text())
        fb = json.loads((db / "meta.json").read_text())
        assert fa["format"] == fb["format"] and fa["step"] == fb["step"] == s
        man_a, man_b = ma.verify(s), mb.verify(s)
        assert man_a["hosts"] == man_b["hosts"]
        assert set(man_a["files"]) == set(man_b["files"])
        for f, rec in man_a["files"].items():
            assert rec.get("keys") == man_b["files"][f].get("keys"), f
            if f.endswith(".npz"):
                with np.load(da / f) as za, np.load(db / f) as zb:
                    _bitwise({k: za[k] for k in za.files},
                             {k: zb[k] for k in zb.files})
    return steps


def test_a_pipe_axis_checkpoints_are_bitwise_the_one_process_ones(
        resume_runs, remesh_runs):
    root, _ = resume_runs
    assert _checkpoints_equal(root / "A", root / "B") == [2, 4, 6]
    root, _ = remesh_runs
    # steps 2 and 4 from four stage ranks (two pods), 6 after the re-mesh
    assert _checkpoints_equal(root / "pipe", root / "flat") == [2, 4, 6]
    meta = json.loads((root / "pipe" / "step_0000000004" /
                       "meta.json").read_text())
    assert meta["format"]["hosts"] == 2
    assert meta["format"]["pipeline"]["plan"]["rows_per_rank"] == [3, 1]


def _jax_template(caps, pods):
    jc = dataclasses.replace(jcfgs.smoke_config("olmo-1b"),
                             num_layers=LAYERS, scan_layers=False)
    tcfg = jcfgs.TrainConfig(model=jc, het=jcfgs.HetConfig(
        pipeline_stages=2, accum_steps=2, capacities=caps))
    mesh = AbstractMesh((2, pods, 1, 1), ("pipe", "pod", "data", "model"))
    return jsteps.state_shapes(jbuild(jc), tcfg, mesh)


def test_b_jax_manager_restores_a_pipe_axis_checkpoint_bitwise(
        resume_runs, remesh_runs):
    for (root, _), caps, pods, steps in (
            (resume_runs, (), 1, (4,)),
            (remesh_runs, (2.0, 1.0), 2, (2, 4))):
        tpl = _jax_template(caps, pods)
        for s in steps:
            got, meta = jckpt.CheckpointManager(str(root / (
                "A" if pods == 1 else "pipe"))).restore(tpl, step=s)
            want, _ = jckpt.CheckpointManager(str(root / (
                "B" if pods == 1 else "flat"))).restore(tpl, step=s)
            assert meta["format"]["pipeline"] is not None
            got = {k: np.asarray(v) for k, v in
                   jrepack.flatten_with_paths(got).items()}
            want = {k: np.asarray(v) for k, v in
                    jrepack.flatten_with_paths(want).items()}
            _bitwise(got, want)


def test_c_resume_on_the_pipe_axis_is_bitwise(resume_runs):
    _, runs = resume_runs
    a, c = runs["A"], runs["C"]
    assert c["start_step"] == 4 and c["steps"] == 6
    assert [r["stage"] for r in c["ranks"]] == [0, 1]
    assert all(r["restore"]["step"] == 4 for r in c["ranks"])
    assert c["losses"] == a["losses"][4:]
    assert c["model_checksum"] == a["model_checksum"]
    assert c["end_checksums"] == a["end_checksums"]


@pytest.mark.parametrize("name", ["D1", "D2"])
def test_d_resume_across_the_pipe_axis_is_bitwise(resume_runs, name):
    _, runs = resume_runs
    a, b, d = runs["A"], runs["B"], runs[name]
    assert a["losses"] == b["losses"]
    assert a["model_checksum"] == b["model_checksum"]
    assert d["pipe_size"] == (1 if name == "D1" else 2)
    assert d["losses"] == a["losses"][4:]
    assert d["model_checksum"] == a["model_checksum"]


def test_e_kill_pod_re_meshes_stage_ranks_across_a_changed_cut(
        remesh_runs):
    _, runs = remesh_runs
    pipe = runs["pipe"][0]
    first, second = pipe["worlds"]
    assert first["devices"] == "2,1,1" and second["devices"] == "1,1"
    assert [r["stage"] for r in first["ranks"]] == [0, 0, 1, 1]
    assert [r["stage"] for r in second["ranks"]] == [0, 1]
    recs = [r["remesh"] for r in first["ranks"]]
    assert all(r == recs[0] for r in recs)
    assert (recs[0]["step"], recs[0]["dead"], recs[0]["checkpoint"]) == \
        (5, [1], 4)
    assert all(r["start_step"] == 4 and r["restore"]["step"] == 4
               for r in second["ranks"])
    # accum 2 -> 4 on one pod: 16 rows in 4 microbatches of 4
    assert second["ranks"][0]["plan"]["rows_per_rank"] == [16]
    assert pipe["steps"] == 6 and len(pipe["losses"]) == 6


def test_e_re_meshed_stage_ranks_are_bitwise_the_run_without_the_axis(
        remesh_runs):
    _, runs = remesh_runs
    pipe, flat = runs["pipe"][0], runs["flat"][0]
    assert [w["devices"] for w in flat["worlds"]] == ["2,1,1", "1,1"]
    assert pipe["losses"] == flat["losses"]
    assert pipe["model_checksum"] == flat["model_checksum"]


def test_e_the_re_mesh_logs_the_changed_cut(remesh_runs):
    _, runs = remesh_runs
    out, text = runs["pipe"]
    assert "each stage on its own ranks (pipe axis: 4 ranks)" in text
    assert "layers per stage [3, 1]" in text
    for needle in ("remesh:", "re-meshed to {'pipe': 2, 'data': 1, "
                   "'model': 1}: 2 rank(s)", "accum_steps scaled x2",
                   "resumed from step 4"):
        assert needle in text, needle
    line = [ln for ln in text.splitlines()
            if "restore: pipeline stage plan changed" in ln]
    assert len(line) == 1
    assert "[3, 1]" in line[0] and "[2, 2]" in line[0]
    assert out["steps"] == 6


def test_the_re_mesh_refuses_microbatches_that_cannot_fill_the_pipe():
    """The re-meshed world's accum must fill the pipe and split its
    buffer; the driver stops before any rank starts."""
    from repro_torch.core import capacity as tcap
    _, tcfg = _split_cfgs("olmo-1b", "adamw", ())
    plan = tcap.plan_capacities(16, (1.0,), round_buffer_to=4)
    ttrain._check_microbatches(dataclasses.replace(
        tcfg, het=dataclasses.replace(tcfg.het, accum_steps=4)), plan)
    with pytest.raises(SystemExit, match="accum_steps 1 does not fit"):
        ttrain._check_microbatches(dataclasses.replace(
            tcfg, het=dataclasses.replace(tcfg.het, accum_steps=1)), plan)
    with pytest.raises(SystemExit, match="does not split into"):
        ttrain._check_microbatches(dataclasses.replace(
            tcfg, het=dataclasses.replace(tcfg.het, accum_steps=3)), plan)


def test_f_a_chaos_preset_on_stage_ranks_replans_as_without_the_axis(
        tmp_path):
    runs = {}
    for name, extra in (("pipe", ["--pipe-axis"]), ("flat", [])):
        runs[name] = ttrain.main(DRIVER + CHAOS + extra + [
            "--data-dir", str(tmp_path / "data")])
    pipe, flat = runs["pipe"], runs["flat"]
    replans = [r["replans"] for r in pipe["ranks"]]
    assert len(replans) == 4 and all(r == replans[0] for r in replans)
    assert replans[0] == flat["ranks"][0]["replans"] == \
        [{"step": 4, "rows": [6, 2]}]
    assert pipe["losses"] == flat["losses"] and len(pipe["losses"]) == 5
    assert pipe["model_checksum"] == flat["model_checksum"]


# --------------------------------------------------------------------------
# (3) a restore on stage ranks, then a step, against JAX's
# --------------------------------------------------------------------------

OPT = dict(name="adamw", lr=3e-3, warmup_steps=1, schedule="constant",
           total_steps=6)


def _step_cfgs():
    tc = dataclasses.replace(tcfgs.smoke_config("olmo-1b"),
                             num_layers=LAYERS, compute_dtype="float32",
                             scan_layers=False, attention_impl="kernel")
    jc = dataclasses.replace(jcfgs.smoke_config("olmo-1b"),
                             num_layers=LAYERS, compute_dtype="float32",
                             scan_layers=False)
    het = dict(pipeline_stages=2, accum_steps=2)
    return (tc, tcfgs.TrainConfig(
                model=tc, shape=tcfgs.ShapeConfig("t", 16, 4, "train"),
                het=tcfgs.HetConfig(**het),
                optimizer=tcfgs.OptimizerConfig(**OPT)),
            jc, jcfgs.TrainConfig(
                model=jc, shape=jcfgs.ShapeConfig("t", 16, 4, "train"),
                het=jcfgs.HetConfig(**het),
                optimizer=jcfgs.OptimizerConfig(**OPT)))


def _step_batch(vocab):
    rng = np.random.default_rng(17)
    return {"inputs": rng.integers(0, vocab, (4, 16)).astype(np.int32),
            "labels": rng.integers(0, vocab, (4, 16)).astype(np.int32),
            "weights": (rng.random((4, 16)) > 0.2).astype(np.float32)}


def restore_step_rank(rank, world, init_method, ck):
    """The step-4 checkpoint restored on this stage rank, checked against
    the host arrays it came from, then one step."""
    torch.set_num_threads(1)
    tc, tcfg, _, _ = _step_cfgs()
    shape, axes = mesh_mod.with_pipe((1, 1), ("data", "model"), 2)
    mesh = mesh_mod.init(shape, axes, rank, init_method, "cpu")
    try:
        model = tbuild(tc, "cpu")
        host, meta = tckpt.CheckpointManager(ck).restore(
            tsteps.state_shapes(model, tcfg, mesh), step=4)
        state = tsteps.state_from_host(host, model, tcfg, mesh)
        splan = tsteps.stage_plan_for(model, tcfg)
        slots = tsteps.host_state_slots(host, tc, splan, mesh.pipe_index)
        exact = all(torch.equal(a, b) for a, b in zip(
            slots, tsteps.stage_state_leaves(state, tc, splan,
                                             mesh.pipe_index)))
        first = splan.stage_ranges()[mesh.pipe_index][0]
        step = tsteps.build_train_step(model, tcfg, mesh)
        state, met = step(state, {k: torch.from_numpy(v) for k, v in
                                  _step_batch(tc.vocab_size).items()})
        own = tsteps.owned_params(state.params, tc, splan, mesh.pipe_index)
        return {"exact": exact, "metrics": {k: float(v)
                                            for k, v in met.items()},
                "params": {tsteps._global_path(p, first): t.numpy().copy()
                           for p, t in tsteps._paths(own)},
                "m": {tsteps._global_path(p, first): t.numpy().copy()
                      for p, t in tsteps._paths(state.opt.m)}}
    finally:
        mesh_mod.destroy(mesh)


def test_restore_on_stage_ranks_then_a_step_matches_jax(resume_runs):
    root, _ = resume_runs
    ck = str(root / "A")
    ranks = mesh_mod.spawn(restore_step_rank, 2, (ck,), timeout_s=600)
    assert all(r["exact"] for r in ranks)
    _, _, jc, jtcfg = _step_cfgs()
    jmodel = jbuild(jc)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])
    with compat.set_mesh(mesh):
        host, meta = jckpt.CheckpointManager(ck).restore(
            jsteps.state_shapes(jmodel, jtcfg, mesh), step=4)
        state = jax.device_put(host, named(
            mesh, jsteps.state_specs(jmodel, jtcfg, mesh)))
        state, met = jsteps.build_train_step(jmodel, jtcfg, mesh)(
            state, {k: jax.numpy.asarray(v) for k, v in
                    _step_batch(jc.vocab_size).items()})
    want = {k: float(v) for k, v in met.items()}
    for r in ranks:
        got = r["metrics"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=GNORM_RTOL)
        assert got["weight"] == want["weight"]
    jtrees = {"params": jax.tree.map(np.asarray, state.params),
              "m": jax.tree.map(np.asarray, state.opt.m)}
    every = {tsteps._global_path(p, 0) for p, _ in
             tsteps._paths(tsteps._param_shapes(_step_cfgs()[0]))}
    for what in ("params", "m"):
        got = {p: a for r in ranks for p, a in r[what].items()}
        assert set(got) == every, what
        for path, g in got.items():
            node = jtrees[what]
            if path[0] == "layers":
                node = node["layers"]
                for k in path[2:]:
                    node = node[k]
                w = node[path[1]]
            else:
                for k in path:
                    node = node[k]
                w = node
            scale = max(float(np.abs(w).max()), 1e-30)
            err = np.abs(g - w)
            assert int(np.sum(err > LEAF_TOL * scale)) <= \
                -(-err.size // 10_000), (what, path)
            assert err.max() <= OUTLIER_TOL * scale, (what, path)
