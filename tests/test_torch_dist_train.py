"""repro_torch's multi-rank train step against the JAX package (CPU, gloo).

Three steps of the port's step on spawned gloo ranks (one process per
data-parallel rank, each on its rows of the packed global batch) against
JAX's ``build_train_step`` on a mesh of forced host devices with Auto
axes (one JAX child process for the file), olmo-1b smoke at fp32, from
the same parameters (drawn by JAX, carried over):

  * ``(2,1,1)`` hierarchical int8 with error feedback, ``bucket_mb``
    0.05, accum 1 and 2;
  * ``(2,1)`` ``bucketed_allreduce`` and plain ``allreduce``
    (``weighted_grad_psum``);
  * ``(2,2,1)`` hierarchical ``none``, capacities 2,1,1,0 (a dead rank:
    all its rows are dummies);
  * ``(2,1,1)`` hierarchical int8 through the legacy per-leaf walk
    (``bucket_mb`` 0).

Compared: loss, grad norm, weight, lr per step; parameters, AdamW
moments and the error state after the third step; every rank ends with
bitwise-equal parameters. Tolerances: fp32 modes those of
``test_torch_train.py`` (the same arithmetic in another order); int8
modes wider, stated below: a quantization code flips where two
gradients differ in the last bit, and each flip moves an element by one
quantization step of its block, which AdamW's normalisation then
spreads into the update.

Also the HetSeq invariant across processes: the dead-rank trajectory
equals a single process trained on the union of the real rows; the
driver's CPU multi-rank run; ``--devices`` parsing; pipeline stages,
which still raise, and the modes ported since, which take a step.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tcfgs
from repro_torch.core import capacity as tcap
from repro_torch.core import dummy as tdummy
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import build_model as tbuild
from repro_torch.optim import adam as tadam

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-5               # loss (fp32), as test_torch_train.py
GNORM_RTOL = 1e-4
LEAF_TOL = 1e-4           # of each leaf's largest magnitude
# int8 modes: a flipped code moves one element by a quantization step
# (1/127 of its block's largest value); the loss barely moves, the
# grad norm by the flips' share, parameters by lr per flipped element
INT8 = {"loss": 1e-4, "grad_norm": 1e-2, "leaf": 2e-2}
# the error state (relative L2, and the share of elements off by more
# than 1e-3 of its largest) after the first step, where only flips of
# the step itself count (largest readings 0.012 and 0.15%), and after
# the third, where the first steps' flips have moved the parameters and
# so every later gradient (0.13 and 2.4%)
ERR_TOL = {1: (0.03, 0.005), 3: (0.25, 0.05)}
SEQ, GLOBAL = 12, 8
OPT = dict(lr=1e-3, warmup_steps=1, schedule="constant", total_steps=3)

# name: (devices, het fields, int8?)
CONFIGS = {
    "hier_int8_ef": ((2, 1, 1), dict(grad_reduction="hierarchical",
                                     compression="int8", bucket_mb=0.05),
                     True),
    "hier_int8_ef_accum2": ((2, 1, 1), dict(
        grad_reduction="hierarchical", compression="int8", bucket_mb=0.05,
        accum_steps=2), True),
    "bucketed_ar": ((2, 1), dict(grad_reduction="bucketed_allreduce",
                                 bucket_mb=0.05), False),
    "allreduce": ((2, 1), dict(grad_reduction="allreduce"), False),
    "hier_none_dead_rank": ((2, 2, 1), dict(
        grad_reduction="hierarchical", compression="none", bucket_mb=0.05,
        capacities=(2.0, 1.0, 1.0, 0.0)), False),
    "hier_int8_legacy": ((2, 1, 1), dict(grad_reduction="hierarchical",
                                         compression="int8", bucket_mb=0.0),
                         True),
}


def _axes(devices):
    return ("data", "model") if len(devices) == 2 else ("pod", "data",
                                                        "model")


def _n_dp(devices):
    return int(np.prod(devices[:-1]))


def _tcfg(cfgs, model_cfg, het, quantize_impl):
    return cfgs.TrainConfig(
        model=model_cfg, shape=cfgs.ShapeConfig("t", SEQ, GLOBAL, "train"),
        het=cfgs.HetConfig(quantize_impl=quantize_impl, **het),
        optimizer=cfgs.OptimizerConfig(**OPT), label_smoothing=0.1)


def _batches(name, devices, het):
    """Three packed global batches (rank-major buffers) from a seed."""
    n = _n_dp(devices)
    caps = het.get("capacities") or (1.0,) * n
    plan = tcap.plan_capacities(GLOBAL, caps, headroom=1.25,
                                round_buffer_to=het.get("accum_steps", 1))
    rng = np.random.default_rng(len(name))
    vocab = tcfgs.smoke_config("olmo-1b").vocab_size
    out = []
    for _ in range(3):
        samples = {k: rng.integers(0, vocab, (GLOBAL, SEQ)).astype(np.int32)
                   for k in ("inputs", "labels")}
        out.append(tdummy.pack_global_batch(samples, plan))
    return plan, out


JAX_CHILD = """
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import compat
from repro.configs import base as cfgs
from repro.launch import steps
from repro.models.model import build_model

spec = json.loads(SPEC)
data = dict(np.load(IN))
out = {}

def flat(tree, prefix):
    if isinstance(tree, dict):
        if not tree:
            out[prefix + "/__empty__"] = np.zeros(0)
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}")
    else:
        out[prefix] = np.asarray(tree)

for name, (devices, het) in spec.items():
    axes = ("data", "model") if len(devices) == 2 else ("pod", "data",
                                                        "model")
    mesh = jax.make_mesh(tuple(devices), axes,
                         axis_types=(AxisType.Auto,) * len(devices))
    mc = dataclasses.replace(cfgs.smoke_config("olmo-1b"),
                             compute_dtype="float32")
    if "capacities" in het:
        het["capacities"] = tuple(het["capacities"])
    tcfg = cfgs.TrainConfig(
        model=mc, shape=cfgs.ShapeConfig("t", SEQ, GLOBAL, "train"),
        het=cfgs.HetConfig(quantize_impl="reference", **het),
        optimizer=cfgs.OptimizerConfig(**OPT), label_smoothing=0.1)
    model = build_model(mc)
    with compat.set_mesh(mesh):
        step = steps.build_train_step(model, tcfg, mesh)
        state = steps.init_train_state(model, tcfg, mesh,
                                       jax.random.PRNGKey(0))
        flat(jax.tree.map(np.asarray, state.params), name + "/params0")
        mets = []
        for i in range(3):
            b = {k: jnp.asarray(data[f"{name}/b{i}/{k}"])
                 for k in ("inputs", "labels", "weights")}
            state, met = step(state, b)
            mets.append([float(met[k]) for k in
                         ("loss", "grad_norm", "weight", "lr")])
            if i == 0 and not (isinstance(state.err, tuple)
                               and state.err == ()):
                flat(jax.tree.map(np.asarray, state.err), name + "/err1")
    out[name + "/metrics"] = np.array(mets)
    flat(jax.tree.map(np.asarray, state.params), name + "/params")
    flat(jax.tree.map(np.asarray, state.opt.m), name + "/m")
    flat(jax.tree.map(np.asarray, state.opt.v), name + "/v")
    if not (isinstance(state.err, tuple) and state.err == ()):
        flat(jax.tree.map(np.asarray, state.err), name + "/err")
# which global rows the batch sharding puts on each (pod, data) device
from jax.sharding import NamedSharding, PartitionSpec as P
m = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                  axis_types=(AxisType.Auto,) * 3)
idx = NamedSharding(m, P(("pod", "data"))).devices_indices_map((16, 3))
for (pod, d, _), dev in np.ndenumerate(m.devices):
    out[f"rows/{pod}/{d}"] = np.array([idx[dev][0].start, idx[dev][0].stop])
np.savez(OUT, **out)
"""


def _sub(npz, prefix):
    """The nested dict stored under ``prefix`` in a flat npz dict."""
    tree = {}
    for key, v in npz.items():
        if key == prefix:
            return v
        if key.startswith(prefix + "/"):
            node = tree
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            if parts[-1] != "__empty__":
                node[parts[-1]] = v
    return tree


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    import json
    tmp = tmp_path_factory.mktemp("jax_dist")
    inputs, spec, plans = {}, {}, {}
    for name, (devices, het, _) in CONFIGS.items():
        plan, batches = _batches(name, devices, het)
        plans[name] = (plan, batches)
        spec[name] = [list(devices), het]
        for i, b in enumerate(batches):
            for k, v in b.items():
                inputs[f"{name}/b{i}/{k}"] = v
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs)
    prog = (f"IN = {str(src)!r}\nOUT = {str(dst)!r}\n"
            f"SPEC = {json.dumps(spec)!r}\nSEQ, GLOBAL = {SEQ}, {GLOBAL}\n"
            f"OPT = {OPT!r}\n" + textwrap.dedent(JAX_CHILD))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return plans, dict(np.load(dst))


def train_rank(rank, world, init_method, runs):
    """One gloo rank: three steps of the port's step for each config of
    this world size; returns metrics, the final state in the JAX layout
    (rank 0) and the error state and a parameter checksum (every
    rank)."""
    mesh_mod.share_cpu(world)
    out = {}
    for name, devices, het, params0, batches, buffer_rows in runs:
        mesh = mesh_mod.init(devices, _axes(devices), rank, init_method,
                             "cpu")
        mc = dataclasses.replace(tcfgs.smoke_config("olmo-1b"),
                                 compute_dtype="float32",
                                 attention_impl="kernel")
        model = tbuild(mc, "cpu")
        tcfg = _tcfg(tcfgs, mc, het, "pallas")
        params = params_from_jax(params0, mc, "cpu")
        state = tsteps.TrainState(
            params=params, opt=tadam.init_state(params, tcfg.optimizer),
            err=tsteps.init_error_state(tcfg, mesh, params))
        step = tsteps.build_train_step(model, tcfg, mesh)
        mets, errs = [], []
        for b in batches:
            mine = {k: torch.from_numpy(np.ascontiguousarray(
                v[rank * buffer_rows:(rank + 1) * buffer_rows]))
                for k, v in b.items()}
            state, met = step(state, mine)
            mets.append([float(met[k]) for k in
                         ("loss", "grad_norm", "weight", "lr")])
            err = state.err
            if isinstance(err, torch.Tensor):
                err = err.numpy().copy()
            elif not (isinstance(err, tuple) and err == ()):
                err = params_to_numpy(err)
            errs.append(err)
        out[name] = {
            "metrics": np.array(mets), "err": errs[-1], "err1": errs[0],
            "checksum": tsteps.params_checksum(state.params),
            "params": params_to_numpy(state.params) if rank == 0 else None,
            "m": params_to_numpy(state.opt.m) if rank == 0 else None,
            "v": params_to_numpy(state.opt.v) if rank == 0 else None}
    mesh_mod.destroy(mesh)
    return out


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """Every config through the port's step: one spawn per world size."""
    plans, jout = jax_runs
    outs = {}
    for world in sorted({_n_dp(d) for d, _, _ in CONFIGS.values()}):
        runs = [(name, devices, het, _sub(jout, name + "/params0"),
                 plans[name][1], plans[name][0].buffer_rows)
                for name, (devices, het, _) in CONFIGS.items()
                if _n_dp(devices) == world]
        per_rank = mesh_mod.spawn(train_rank, world, (runs,), timeout_s=600)
        for name, *_ in runs:
            outs[name] = [r[name] for r in per_rank]
    return outs


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_close(got, want, tol, what):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), what
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (what, path)
        atol = tol * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_multi_rank_steps_match_jax(name, jax_runs, port_runs):
    devices, het, int8 = CONFIGS[name]
    _, jout = jax_runs
    ranks = port_runs[name]
    assert len(ranks) == _n_dp(devices)
    assert len({r["checksum"] for r in ranks}) == 1   # identical params
    want = jout[name + "/metrics"]
    for r in ranks:
        np.testing.assert_array_equal(r["metrics"], ranks[0]["metrics"])
    got = ranks[0]["metrics"]
    tol = INT8 if int8 else {"loss": RTOL, "grad_norm": GNORM_RTOL,
                             "leaf": LEAF_TOL}
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=tol["loss"])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=tol["grad_norm"])
    np.testing.assert_array_equal(got[:, 2], want[:, 2])     # weight
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-7)
    for what in ("params", "m", "v"):
        _assert_trees_close(ranks[0][what], _sub(jout, f"{name}/{what}"),
                            tol["leaf"], f"{name} {what}")
    if het.get("compression", "none") == "none":
        assert all(isinstance(r["err"], tuple) for r in ranks)
        return
    for after, key, jkey in ((1, "err1", "/err1"), (3, "err", "/err")):
        jerr = _sub(jout, name + jkey)
        max_rel, max_share = ERR_TOL[after]
        for pod, r in enumerate(ranks):            # data = 1: rank = pod
            if isinstance(jerr, np.ndarray):       # bucketed (pods, nb, be)
                g, w = r[key], jerr[pod]
            else:                                  # legacy: tree mirror
                g = np.concatenate([v.reshape(-1) for v in _flat(
                    r[key]).values()])
                w = np.concatenate([v[pod].reshape(-1) for v in _flat(
                    jerr).values()])
            assert g.shape == w.shape
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            share = np.mean(np.abs(g - w) > 1e-3 * np.abs(w).max())
            assert rel <= max_rel and share <= max_share, (
                name, after, pod, rel, share)


def test_dead_rank_trajectory_equals_single_process(jax_runs, port_runs):
    """The HetSeq invariant across processes: four ranks of capacities
    2,1,1,0 (the last all dummies) train as one process does on the
    union of the real rows."""
    plans, jout = jax_runs
    name = "hier_none_dead_rank"
    plan, batches = plans[name]
    assert plan.rows_per_rank.tolist()[-1] == 0
    mc = dataclasses.replace(tcfgs.smoke_config("olmo-1b"),
                             compute_dtype="float32",
                             attention_impl="kernel")
    tcfg = _tcfg(tcfgs, mc, {}, "pallas")
    params = params_from_jax(_sub(jout, name + "/params0"), mc, "cpu")
    state = tsteps.TrainState(params=params, opt=tadam.init_state(
        params, tcfg.optimizer), err=())
    step = tsteps.build_train_step(tbuild(mc, "cpu"), tcfg)
    mets = []
    for b in batches:
        real = b["weights"].sum(axis=1) > 0
        assert real.sum() == GLOBAL
        state, met = step(state, {k: torch.from_numpy(v[real])
                                  for k, v in b.items()})
        mets.append([float(met[k]) for k in ("loss", "grad_norm", "weight",
                                             "lr")])
    got = port_runs[name][0]
    np.testing.assert_allclose(got["metrics"][:, 0], np.array(mets)[:, 0],
                               rtol=RTOL)
    np.testing.assert_allclose(got["metrics"][:, 1], np.array(mets)[:, 1],
                               rtol=GNORM_RTOL)
    _assert_trees_close(got["params"], params_to_numpy(state.params),
                        LEAF_TOL, "dead rank vs single process")


def test_rank_rows_follow_the_jax_batch_sharding(jax_runs):
    """Rank r = pod * data + d takes rows [r*b, (r+1)*b) of the packed
    batch: the rows JAX's P(("pod", "data")) sharding puts on mesh
    device (pod, d), here for a (2, 2, 1) mesh and 16 rows."""
    _, jout = jax_runs
    for pod in range(2):
        for d in range(2):
            r = pod * 2 + d
            assert jout[f"rows/{pod}/{d}"].tolist() == [r * 4, (r + 1) * 4]


def test_devices_parsing_and_unported_modes():
    assert mesh_mod.parse_devices("2,1") == ((2, 1), ("data", "model"))
    assert mesh_mod.parse_devices("2,2,1") == ((2, 2, 1),
                                               ("pod", "data", "model"))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        mesh_mod.parse_devices("2,2")
    with pytest.raises(SystemExit):
        mesh_mod.parse_devices("2")
    assert mesh_mod.choose_backend("cpu", 2, 0) == ("gloo", "direct")
    assert mesh_mod.choose_backend("cuda", 2, 1) == ("gloo", "direct")
    assert mesh_mod.choose_backend("cuda", 2, 2) == ("nccl", "direct")
    mc = dataclasses.replace(tcfgs.smoke_config("olmo-1b"),
                             scan_layers=False)
    model = tbuild(mc, "cpu")
    tcfg = tcfgs.TrainConfig(model=mc, het=tcfgs.HetConfig(
        accum_steps=2, pipeline_stages=2))
    with pytest.raises(ValueError, match="pipe"):      # sized to the stages
        tsteps.build_train_step(model, tcfg, mesh_mod.unjoined(
            *mesh_mod.with_pipe((1, 1), ("data", "model"), 3)))
    # the ported modes build and take a step on a one-rank (pod, data,
    # model) mesh (the overlap pipelines over a pod group of one; the
    # pipeline stages in one process)
    mesh = mesh_mod.local((1, 1, 1), ("pod", "data", "model"))
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, mc.vocab_size, (4, 8))
                                 .astype(np.int32)) for k in ("inputs",
                                                              "labels")}
    batch["weights"] = torch.ones((4, 8))
    for het, opt in ((dict(overlap="buckets", bucket_mb=1.0,
                           grad_reduction="hierarchical"), {}),
                     (dict(overlap="backward", bucket_mb=1.0,
                           grad_reduction="hierarchical"), {}),
                     (dict(weighting="canonical"), {}),
                     (dict(pipeline_stages=2, accum_steps=2), {}),
                     ({}, dict(name="lamb"))):
        tcfg = tcfgs.TrainConfig(model=mc, het=tcfgs.HetConfig(**het),
                                 optimizer=tcfgs.OptimizerConfig(**opt))
        state = tsteps.init_train_state(model, tcfg, mesh=mesh)
        state, met = tsteps.build_train_step(model, tcfg, mesh)(state,
                                                                 batch)
        assert np.isfinite(float(met["loss"]))


def test_cpu_driver_trains_two_ranks_with_the_int8_exchange():
    out = ttrain.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                       "--devices", "2,1,1", "--grad-reduction",
                       "hierarchical", "--compression", "int8",
                       "--bucket-mb", "0.05", "--capacities", "2,1",
                       "--steps", "6", "--global-batch", "8", "--seq-len",
                       "16", "--accum", "2", "--lr", "3e-3", "--warmup",
                       "1", "--schedule", "constant", "--log-every", "3"])
    assert out["steps"] == 6 and all(np.isfinite(out["losses"]))
    assert out["last_loss"] < out["first_loss"]
    assert len(out["ranks"]) == 2 and out["transport"] == "direct"
    assert len(set(out["end_checksums"])) == 1
    assert out["plan"]["rows_per_rank"] == [5, 3]       # capacities 2,1
    assert all(m["weight"] == 8 * 16 for m in out["metrics"])
    # wire bytes per step per rank: the model's, for 2 ranks
    from repro_torch.core import buckets as tbkt
    mc = tcfgs.smoke_config("olmo-1b")
    lo = tbkt.build_layout(tbuild(mc, "cpu").init_params(0),
                           bucket_mb=0.05, multiple_of=512)
    want = tbkt.modeled_link_bytes(lo, 2, compress=True)
    for r in out["ranks"]:
        assert r["link_bytes"] == [want] * 6
        assert r["launches"]["quantize_int8_cuda"] == 0    # CPU: plain
