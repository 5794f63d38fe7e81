"""repro_torch's pipeline stages on their own ranks: the ``pipe`` mesh
axis (CPU, gloo).

  (a) ``launch/mesh.py``: a leading ``pipe`` axis's groups (rank ``r =
      stage * dp + dp_rank``; the dp group is my stage's ranks, the pipe
      group my data-parallel index's), and ``PipeHop``'s message lines:
      every message of two stages numbered in program order, the same
      numbering on both sides;
  (b) the pipelined step on stage ranks, 2 stages x 1 and x 2
      data-parallel ranks and 3 stages x 1, bitwise the one-process
      pipelined step (itself bitwise the one-stage step,
      ``test_torch_pipeline.py``) in losses and every parameter leaf (a
      tied table's copy on stage 0 too), for allreduce and
      bucketed_allreduce, AdamW and LAMB, 1F1B and GPipe, the uniform
      and a capacity cut; the pipe group's bytes a step equal to
      ``modeled_pipe_bytes`` with the touched rows counted from the
      batch in the test;
  (c) the driver: ``--pipe-axis`` trains on four ranks with every
      stage's ranks equal and the model's checksum that of the run
      without it (checkpoints, ``--resume``, ``--chaos`` and
      ``--kill-pod`` on the pipe axis: ``test_torch_pipe_axis_ckpt.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tcfgs
from repro_torch.core import pipeline as tpipe
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.model import build_model as tbuild

SEQ, GLOBAL, LAYERS = 12, 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size steps run fastest on one intra-op thread, and the suite
    runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# (a) the mesh's groups and the hop's message lines
# --------------------------------------------------------------------------


def test_pipe_axis_groups():
    shape, axes = mesh_mod.with_pipe((2, 2, 1), ("pod", "data", "model"), 3)
    assert (shape, axes) == ((3, 2, 2, 1), ("pipe", "pod", "data", "model"))
    g = mesh_mod._groups(dict(zip(axes, shape)))
    assert g["dp"] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    assert g["pipe"] == [[0, 4, 8], [1, 5, 9], [2, 6, 10], [3, 7, 11]]
    assert g["pod"][:2] == [[0, 2], [1, 3]] and g["pod"][-1] == [9, 11]
    assert g["data"][:2] == [[0, 1], [2, 3]]
    m = mesh_mod.unjoined(shape, axes)
    assert (m.pipe_size, m.dp_size) == (3, 4)
    for rank, (stage, dp, pod, data) in {0: (0, 0, 0, 0), 5: (1, 1, 0, 1),
                                         10: (2, 2, 1, 0)}.items():
        m.rank = rank
        assert (m.pipe_index, m.dp_rank, m.pod_index, m.data_index) == \
            (stage, dp, pod, data)
    with pytest.raises(ValueError, match="pipeline_stages >= 2"):
        mesh_mod.with_pipe((1, 1), ("data", "model"), 1)


@pytest.mark.parametrize("S,M,schedule,tied", [(2, 4, "1f1b", True),
                                               (3, 4, "gpipe", True),
                                               (4, 7, "1f1b", False)])
def test_hop_lines_follow_program_order(S, M, schedule, tied):
    order = tpipe.program_order(S, M, schedule)
    comm = mesh_mod.local().pipe
    hops = [tsteps.PipeHop(comm, order, S, s, tied, torch.device("cpu"))
            for s in range(S)]
    for s, hop in enumerate(hops):
        for peer, line in hop.lines.items():
            assert hops[peer].lines[s] == line      # one numbering, both
            assert all(s in msg[2:] and peer in msg[2:] for msg in line)
    # the activations and cotangents of each boundary, in microbatch
    # order; the tied table's rows and the table after the update
    for s in range(S - 1):
        line = hops[s].lines[s + 1]
        assert [m for k, m, *_ in line if k == "F"] == list(range(M))
        assert [m for k, m, *_ in line if k == "B"] == list(range(M))
    if tied:
        last = hops[0].lines[S - 1]
        assert [m for k, m, *_ in last if k == "T"] == list(range(M))
        assert last[-1][:2] == ("E", 0)


# --------------------------------------------------------------------------
# (b) the step on stage ranks
# --------------------------------------------------------------------------

CASES = [("allreduce", "adamw", "1f1b", ()),
         ("allreduce", "lamb", "gpipe", (3.0, 1.0)),
         ("bucketed_allreduce", "adamw", "gpipe", (3.0, 1.0)),
         ("bucketed_allreduce", "lamb", "1f1b", ())]


def _tc(remat="none"):
    return dataclasses.replace(tcfgs.smoke_config("olmo-1b"),
                               compute_dtype="float32", scan_layers=False,
                               num_layers=LAYERS, attention_impl="kernel",
                               remat=remat)


def _tcfg(tc, stages, red, opt, sched, caps, accum=4):
    return tcfgs.TrainConfig(
        model=tc, shape=tcfgs.ShapeConfig("t", SEQ, GLOBAL, "train"),
        het=tcfgs.HetConfig(
            grad_reduction=red, bucket_mb=0.01 if red != "allreduce"
            else 0.0, accum_steps=accum, pipeline_stages=stages,
            pipeline_schedule=sched, capacities=caps),
        optimizer=tcfgs.OptimizerConfig(name=opt, lr=1e-2, warmup_steps=1,
                                        schedule="constant", grad_clip=0.0),
        label_smoothing=0.1)


def _batches(ranks, rank, steps=3):
    rng = np.random.default_rng(11)
    vocab = tcfgs.smoke_config("olmo-1b").vocab_size
    out = []
    for _ in range(steps):
        b = {"inputs": rng.integers(0, vocab // 4, (GLOBAL, SEQ)).astype(
                 np.int32),
             "labels": rng.integers(0, vocab, (GLOBAL, SEQ)).astype(
                 np.int32),
             "weights": (rng.random((GLOBAL, SEQ)) > 0.2).astype(
                 np.float32)}
        n = GLOBAL // ranks
        out.append({k: torch.from_numpy(v[rank * n:(rank + 1) * n])
                    for k, v in b.items()})
    return out


def _touched(batch, accum):
    return [int(torch.unique(x).numel())
            for x in batch["inputs"].reshape(accum, -1)]


def stage_rank(rank, world, init_method, stages, dp, cases, remat, accum):
    """Each case's three steps on this rank: losses, the parameters it
    holds (by path in the full tree), the pipe bytes and their model a
    step. Without a pipe axis (``world == dp``) the one-process step."""
    torch.set_num_threads(1)
    shape, axes = (dp, 1), ("data", "model")
    staged = world > dp
    if staged:
        shape, axes = mesh_mod.with_pipe(shape, axes, stages)
    mesh = (mesh_mod.init(shape, axes, rank, init_method, "cpu")
            if world > 1 else mesh_mod.local(shape, axes))
    tc = _tc(remat)
    model = tbuild(tc, "cpu")
    out = {}
    try:
        for case in cases:
            tcfg = _tcfg(tc, stages, *case, accum=accum)
            splan = tsteps.stage_plan_for(model, tcfg)
            state = tsteps.init_train_state(model, tcfg, mesh=mesh)
            step = tsteps.build_train_step(model, tcfg, mesh)
            first = splan.stage_ranges()[mesh.pipe_index][0]
            losses, sent, modeled = [], [], []
            for b in _batches(dp, mesh.dp_rank):
                p0 = mesh.pipe.sent_bytes
                state, met = step(state, b)
                losses.append(float(met["loss"]))
                sent.append(mesh.pipe.sent_bytes - p0)
                modeled.append(tsteps.modeled_pipe_bytes(
                    tc, splan, tcfg.optimizer, microbatches=accum,
                    mb_rows=b["inputs"].shape[0] // accum, seq_len=SEQ,
                    stage=mesh.pipe_index,
                    touched_rows=_touched(b, accum)))
            out[case] = {
                "losses": losses, "stage": mesh.pipe_index,
                "params": {tsteps._global_path(p, first):
                           t.detach().numpy().copy()
                           for p, t in tsteps._paths(state.params)},
                "sent": sent, "modeled": modeled}
    finally:
        mesh_mod.destroy(mesh)
    return out


def _run(stages, dp, staged, cases=CASES, remat="none", accum=4):
    world = stages * dp if staged else dp
    args = (stages, dp, cases, remat, accum)
    if world == 1:
        return [stage_rank(0, 1, None, *args)]
    return mesh_mod.spawn(stage_rank, world, args, timeout_s=600)


@pytest.fixture(scope="module")
def grids():
    out = {}
    for stages, dp, remat in ((2, 1, "none"), (2, 2, "none")):
        out[(stages, dp)] = (_run(stages, dp, False, remat=remat),
                             _run(stages, dp, True, remat=remat))
    three = [CASES[1], CASES[3]]
    out[(3, 1)] = (_run(3, 1, False, three, "full"),
                   _run(3, 1, True, three, "full"))
    return out


def _check(one, staged, case, stages, dp):
    for r in staged:
        assert r[case]["losses"] == one[0][case]["losses"]
        assert r[case]["sent"] == r[case]["modeled"], (r[case]["stage"],)
        assert all(b > 0 for b in r[case]["sent"])
    for d in range(dp):
        want = one[d][case]["params"]
        got = {}
        for s in range(stages):
            for path, a in staged[s * dp + d][case]["params"].items():
                if path in got:                 # the tied table's copy
                    assert np.array_equal(got[path], a), path
                got[path] = a
        assert set(got) == set(want)
        for path, w in want.items():
            assert np.array_equal(got[path], w), path


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("stages,dp", [(2, 1), (2, 2)])
def test_stage_ranks_bitwise_one_process(stages, dp, case, grids):
    one, staged = grids[(stages, dp)]
    _check(one, staged, case, stages, dp)


@pytest.mark.parametrize("case", [CASES[1], CASES[3]])
def test_three_stage_ranks_bitwise_one_process_under_remat(case, grids):
    one, staged = grids[(3, 1)]
    _check(one, staged, case, 3, 1)
    # the middle stage's bytes: activations and cotangents both ways,
    # and its rows of the gathers
    mid = staged[1][case]
    assert mid["sent"][0] == 2 * 4 * (2 * SEQ * 64 * 4 + 4) + 2 * 4 * (
        3 + 1 + LAYERS * 7 + (2 * (1 + LAYERS * 7)
                              if case[1] == "lamb" else 0))


# --------------------------------------------------------------------------
# (c) the driver
# --------------------------------------------------------------------------

DRIVER = ["--arch", "olmo-1b", "--smoke", "--device", "cpu",
          "--pipeline-stages", "2", "--no-scan-layers", "--accum", "2",
          "--steps", "3", "--global-batch", "8", "--seq-len", "16",
          "--lr", "3e-3", "--warmup", "1", "--schedule", "constant",
          "--log-every", "1"]


def test_driver_pipe_axis_matches_one_process(capsys):
    one = ttrain.main(DRIVER + ["--devices", "2,1"])
    staged = ttrain.main(DRIVER + ["--devices", "2,1", "--pipe-axis"])
    text = capsys.readouterr().out
    assert "each stage on its own ranks (pipe axis: 4 ranks)" in text
    assert "identical on every rank of each of the 2 stages" in text
    assert staged["losses"] == one["losses"]
    assert staged["model_checksum"] == one["model_checksum"] == \
        one["end_checksums"][0]
    sums = staged["end_checksums"]
    assert len(sums) == 4 and sums[0] == sums[1] and sums[2] == sums[3]
    ranks = staged["ranks"]
    assert [r["stage"] for r in ranks] == [0, 0, 1, 1]
    for r in ranks:
        assert r["pipe_bytes"] == r["pipe_bytes_modeled"]
    assert all(r["pipe_bytes"] == [0] * 3 for r in one["ranks"])
    summary = [ln for ln in text.splitlines()
               if ln.startswith("[train] summary ")]
    assert '"stage_plan": [1, 1]' in summary[-1] and \
        '"schedule": "1f1b"' in summary[-1]
