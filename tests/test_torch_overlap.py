"""repro_torch's overlapped bucket exchange and overlap train steps
(CPU, gloo), against the port's own monolithic step and the JAX
package.

  (a) ``bucket_readiness`` over ``staged_leaf_pieces`` equals the JAX
      package's tuples on the smoke olmo-1b (tied) and tinyllama-1.1b
      (a separate head) layouts at several bucket sizes;
  (b) ``BucketFlushPipeline``: bucket k's prep before the previous
      bucket's exchange, results in bucket-index order, errors for a
      double flush and for ``finish()`` before every bucket flushed;
  (c) on 2 and 4 gloo ranks, ``Comm.all_gather(async_op=True)`` the
      blocking call's rows and bytes, and ``exchange_buckets_overlapped``
      bitwise
      ``exchange_buckets`` (fp32, and int8 with error feedback over a
      layout whose last bucket ends in padding), each bucket handed to
      the hook once, in order, and the bytes sent those of the
      monolithic exchange (2 ranks: ``modeled_bucket_link_bytes``
      summed);
  (d) train steps on 2 and 4 gloo ranks, olmo-1b smoke at fp32,
      ``scan_layers=False``: ``overlap="buckets"`` and ``"backward"``
      bitwise ``"none"`` (losses, parameters, the error state) with
      ``grad_clip=0``, for ``bucketed_allreduce`` and hierarchical
      (fp32 and int8 with error feedback), accum 1 and 2; with LAMB and
      with a clip, ``"buckets"`` bitwise ``"backward"``;
  (e) three overlap steps against JAX's ``build_train_step`` on forced
      host devices (Auto axes, one JAX child process), from the same
      parameters and batches, to ``test_torch_dist_train.py``'s
      tolerances: fp32 loss 1e-5 relative, grad norm and trust ratio
      1e-4, every parameter and moment leaf 1e-4 of its largest
      magnitude; int8 1e-4, 1e-2 and 2e-2, the error state after three
      steps within 0.25 relative L2 with at most 5% of its elements off
      by more than 1e-3 of its largest (a quantization code flips where
      two gradients differ in the last bit).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.core import buckets as jbkt
from repro.launch import steps as jsteps
from repro.models.model import build_model as jbuild
from repro_torch.configs import base as tcfgs
from repro_torch.core import buckets as tbkt
from repro_torch.core import capacity as tcap
from repro_torch.core import dummy as tdummy
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import build_model as tbuild
from repro_torch.optim import adam as tadam

REPO = Path(__file__).resolve().parent.parent
SEQ, GLOBAL = 12, 8
RTOL, GNORM_RTOL, LEAF_TOL = 1e-5, 1e-4, 1e-4
INT8 = {"loss": 1e-4, "grad_norm": 1e-2, "leaf": 2e-2}
ERR_TOL = (0.25, 0.05)


# --------------------------------------------------------------------------
# (a) readiness, (b) the flush pipeline
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bucket_mb,multiple_of", [(0.02, 512),
                                                   (0.05, 1024),
                                                   (0.005, 256)])
@pytest.mark.parametrize("arch", ["olmo-1b", "tinyllama-1.1b"])
def test_bucket_readiness_matches_jax(arch, bucket_mb, multiple_of):
    jc = dataclasses.replace(jcfgs.smoke_config(arch), scan_layers=False)
    tc = dataclasses.replace(tcfgs.smoke_config(arch), scan_layers=False)
    jshape = jax.eval_shape(jbuild(jc).init_params, jax.random.PRNGKey(0))
    tparams = tbuild(tc, "cpu").init_params(0)
    jpieces = jsteps._staged_leaf_pieces(jshape, jc)
    tpieces = tsteps.staged_leaf_pieces(tparams, tc)
    assert tpieces == [list(p) for p in jpieces]
    jlo = jbkt.build_layout(jshape, bucket_mb=bucket_mb,
                            multiple_of=multiple_of)
    tlo = tbkt.build_layout(tparams, bucket_mb=bucket_mb,
                            multiple_of=multiple_of)
    ready = tbkt.bucket_readiness(tlo, tpieces)
    assert ready == jbkt.bucket_readiness(jlo, jpieces)
    L = tc.num_layers
    assert ready[0] == L + 1                    # the embedding: last
    assert set(ready) <= set(range(L + 2))
    with pytest.raises(ValueError, match="tile"):
        tbkt.bucket_readiness(tlo, [[(1, 3, 0)]] + tpieces[1:])


def test_flush_pipeline_double_buffer_ordering_and_errors():
    readiness = (2, 0, 1, 0)            # flush order: 1, 3, 2, 0
    log = []

    def prep(k, raw_k):
        log.append(("prep", k))
        return raw_k

    def exchange(k, prepared):
        log.append(("exchange", k))
        return prepared * 10.0

    pipe = tbkt.BucketFlushPipeline(readiness, prep, exchange)
    raw = torch.arange(4.0)
    for stage in range(3):
        pipe.flush_ready_buckets(stage, lambda k: raw[k])
    outs = pipe.finish()
    assert torch.equal(torch.stack(outs), torch.tensor([0., 10., 20., 30.]))
    assert log == [("prep", 1), ("prep", 3), ("exchange", 1),
                   ("prep", 2), ("exchange", 3), ("prep", 0),
                   ("exchange", 2), ("exchange", 0)]
    again = tbkt.BucketFlushPipeline(readiness, prep, exchange)
    again.flush_ready_buckets(0, lambda k: raw[k])
    with pytest.raises(ValueError, match="flushed twice"):
        again.flush_ready_buckets(0, lambda k: raw[k])
    short = tbkt.BucketFlushPipeline(readiness, prep, exchange)
    short.flush_ready_buckets(0, lambda k: raw[k])
    with pytest.raises(ValueError, match="finish"):
        short.finish()


# --------------------------------------------------------------------------
# (c) the overlapped exchange on gloo ranks
# --------------------------------------------------------------------------

# name: (ranks, compress, error feedback, stream elements); 256-element
# quantization blocks, buckets of multiple_of = ranks * 256
EXCHANGES = {"fp32": (2, False, False, 9000),
             "int8_ef_tail": (2, True, True, 9000),
             "fp32_4": (4, False, False, 9000),
             "int8_ef_tail_4": (4, True, True, 10_000)}


def _exchange_case(name):
    p, compress, ef, n = EXCHANGES[name]
    lo = tbkt.build_layout({"s": torch.empty(n)}, bucket_mb=1500 * 4 / 2**20,
                           multiple_of=p * 256)
    rng = np.random.default_rng(n + p)
    x = np.zeros((p, lo.num_buckets, lo.bucket_elems), np.float32)
    x.reshape(p, -1)[:, :n] = rng.standard_normal((p, n)) * rng.random(
        (p, 1)) * 3
    err = None
    if ef:
        err = np.zeros_like(x)
        err.reshape(p, -1)[:, :n] = rng.standard_normal((p, n)) * 1e-3
    return lo, x, err


def exchange_rank(rank, world, init_method, names):
    mesh_mod.share_cpu(world)
    mesh = mesh_mod.init((world, 1, 1), ("pod", "data", "model"), rank,
                         init_method, "cpu")
    out = {}
    try:
        comm = mesh.pod
        x0 = torch.arange(6.0) + rank
        sent0 = comm.sent_bytes
        blocking = comm.all_gather(x0)
        mid = comm.sent_bytes
        pending = comm.all_gather(x0, async_op=True)
        out["async_all_gather"] = (
            bool(torch.equal(pending.wait(), blocking))
            and comm.sent_bytes - mid == mid - sent0 > 0)
        for name in names:
            _, compress, _, _ = EXCHANGES[name]
            lo, x, err = _exchange_case(name)
            res = {}
            for kind in ("mono", "over"):
                stack = torch.from_numpy(x[rank].copy())
                e = None if err is None else torch.from_numpy(
                    err[rank].copy())
                sent0 = comm.sent_bytes
                if kind == "mono":
                    tbkt.exchange_buckets(stack, e, comm=comm,
                                          compress=compress, total=lo.total,
                                          impl="kernel")
                    seen = None
                else:
                    seen = []
                    outs, _ = tbkt.exchange_buckets_overlapped(
                        stack, e, comm=comm, compress=compress,
                        total=lo.total, impl="kernel",
                        bucket_fn=lambda k, red: seen.append(
                            (k, red.clone().numpy())) or k)
                    assert outs == list(range(lo.num_buckets))
                res[kind] = {"red": stack.numpy(), "sent":
                             comm.sent_bytes - sent0,
                             "err": None if e is None else e.numpy(),
                             "seen": seen}
            out[name] = res
    finally:
        mesh_mod.destroy(mesh)
    return out


@pytest.fixture(scope="module")
def exchanges():
    outs = {}
    for p in (2, 4):
        names = [n for n, c in EXCHANGES.items() if c[0] == p]
        per_rank = mesh_mod.spawn(exchange_rank, p, (names,), timeout_s=300)
        for name in names + ["async_all_gather"]:
            outs[f"{name}/{p}" if name == "async_all_gather" else name] = \
                [r[name] for r in per_rank]
    return outs


@pytest.mark.parametrize("ranks", [2, 4])
def test_async_all_gather_matches_blocking(ranks, exchanges):
    """``Comm.all_gather(async_op=True)``: the same rows once waited on,
    the same bytes counted when issued."""
    assert all(exchanges[f"async_all_gather/{ranks}"])


@pytest.mark.parametrize("name", list(EXCHANGES))
def test_overlapped_exchange_bitwise_monolithic(name, exchanges):
    p, compress, ef, _ = EXCHANGES[name]
    lo, _, _ = _exchange_case(name)
    assert lo.num_buckets >= 3 and lo.padded_total > lo.total
    for r in exchanges[name]:
        mono, over = r["mono"], r["over"]
        np.testing.assert_array_equal(over["red"], mono["red"])
        if ef:
            np.testing.assert_array_equal(over["err"], mono["err"])
            assert np.any(over["err"])
        assert [k for k, _ in over["seen"]] == list(range(lo.num_buckets))
        for k, red in over["seen"]:              # handed over as it landed
            np.testing.assert_array_equal(red, mono["red"][k])
        assert over["sent"] == mono["sent"]
        if p == 2:
            assert over["sent"] == sum(
                tbkt.modeled_bucket_link_bytes(lo, p, k, compress=compress)
                for k in range(lo.num_buckets))


# --------------------------------------------------------------------------
# (d) the overlap steps against the port's monolithic step
# --------------------------------------------------------------------------

# name: (devices, het fields, optimizer fields, modes compared)
ALL = ("none", "buckets", "backward")
STEPS = {
    "bucketed": ((2, 1), dict(grad_reduction="bucketed_allreduce",
                              bucket_mb=0.05), {}, ALL),
    "bucketed_accum2": ((2, 1), dict(grad_reduction="bucketed_allreduce",
                                     bucket_mb=0.05, accum_steps=2), {},
                        ALL),
    "hier_fp32": ((2, 1, 1), dict(grad_reduction="hierarchical",
                                  bucket_mb=0.05), {}, ALL),
    "hier_int8_ef_accum2": ((2, 1, 1), dict(
        grad_reduction="hierarchical", compression="int8", bucket_mb=0.05,
        accum_steps=2), {}, ALL),
    "bucketed_lamb": ((2, 1), dict(grad_reduction="bucketed_allreduce",
                                   bucket_mb=0.05), dict(name="lamb"),
                      ("buckets", "backward")),
    "hier_int8_clip": ((2, 1, 1), dict(grad_reduction="hierarchical",
                                       compression="int8", bucket_mb=0.05),
                       dict(grad_clip=1.0), ("buckets", "backward")),
    "hier_fp32_2x2_accum2": ((2, 2, 1), dict(
        grad_reduction="hierarchical", bucket_mb=0.02, accum_steps=2,
        capacities=(2.0, 1.0, 1.0, 0.0)), {}, ALL),
    "bucketed_4": ((4, 1), dict(grad_reduction="bucketed_allreduce",
                                bucket_mb=0.02), dict(name="lamb"),
                   ("buckets", "backward")),
}


def _axes(devices):
    return ("data", "model") if len(devices) == 2 else ("pod", "data",
                                                        "model")


def _world(devices):
    return int(np.prod(devices[:-1]))


def _smoke():
    return dataclasses.replace(tcfgs.smoke_config("olmo-1b"),
                               compute_dtype="float32",
                               attention_impl="kernel", scan_layers=False)


def _batches(name, devices, het, seed):
    n = _world(devices)
    caps = het.get("capacities") or (2.0,) + (1.0,) * (n - 1)
    plan = tcap.plan_capacities(GLOBAL, caps, headroom=1.25,
                                round_buffer_to=het.get("accum_steps", 1))
    rng = np.random.default_rng(seed)
    vocab = tcfgs.smoke_config("olmo-1b").vocab_size
    return plan, [tdummy.pack_global_batch(
        {k: rng.integers(0, vocab, (GLOBAL, SEQ)).astype(np.int32)
         for k in ("inputs", "labels")}, plan) for _ in range(3)]


def _tcfg(het, opt, overlap):
    return tcfgs.TrainConfig(
        model=_smoke(), shape=tcfgs.ShapeConfig("t", SEQ, GLOBAL, "train"),
        het=tcfgs.HetConfig(quantize_impl="pallas", overlap=overlap, **het),
        optimizer=tcfgs.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                        schedule="constant", total_steps=3,
                                        **{"grad_clip": 0.0, **opt}),
        label_smoothing=0.1)


def _state(model, tcfg, mesh, params0):
    """The port's initial state from JAX-layout parameters (or its own
    seed-0 parameters)."""
    if params0 is None:
        return tsteps.init_train_state(model, tcfg, mesh=mesh)
    params = params_from_jax(params0, model.cfg, "cpu")
    lo = tsteps.bucket_layout(tcfg, mesh, params)
    return tsteps.TrainState(
        params=params, opt=tadam.init_state_flat(
            lo.num_buckets, lo.bucket_elems, tcfg.optimizer),
        err=tsteps.init_error_state(tcfg, mesh, params))


def steps_rank(rank, world, init_method, runs):
    """Three steps for every (config, mode) of this world size; per run
    the metrics, the final parameters (JAX layout), moments, error state
    and a parameter checksum."""
    mesh_mod.share_cpu(world)
    model = tbuild(_smoke(), "cpu")
    out = {}
    for key, devices, het, opt, overlap, batches, b, params0 in runs:
        mesh = mesh_mod.init(devices, _axes(devices), rank, init_method,
                             "cpu")
        tcfg = _tcfg(het, opt, overlap)
        state = _state(model, tcfg, mesh, params0)
        step = tsteps.build_train_step(model, tcfg, mesh)
        mets = []
        for bt in batches:
            state, met = step(state, {k: torch.from_numpy(np.ascontiguousarray(
                v[rank * b:(rank + 1) * b])) for k, v in bt.items()})
            mets.append({k: float(v) for k, v in met.items()})

        def host(t):
            return (t.numpy().copy() if isinstance(t, torch.Tensor)
                    else params_to_numpy(t))
        out[key] = {"metrics": mets, "params": params_to_numpy(state.params),
                    "m": host(state.opt.m), "v": host(state.opt.v),
                    "err": (state.err.numpy().copy()
                            if isinstance(state.err, torch.Tensor) else None),
                    "checksum": tsteps.params_checksum(state.params)}
    mesh_mod.destroy(mesh)
    return out


def _spawn_runs(runs_by_world):
    outs = {}
    for world, runs in sorted(runs_by_world.items()):
        per_rank = mesh_mod.spawn(steps_rank, world, (runs,), timeout_s=900)
        for key, *_ in runs:
            outs[key] = [r[key] for r in per_rank]
    return outs


@pytest.fixture(scope="module")
def overlap_steps():
    runs = {}
    for name, (devices, het, opt, modes) in STEPS.items():
        plan, batches = _batches(name, devices, het, len(name))
        for mode in modes:
            runs.setdefault(_world(devices), []).append(
                (f"{name}/{mode}", devices, het, opt, mode, batches,
                 plan.buffer_rows, None))
    return _spawn_runs(runs)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", list(STEPS))
def test_overlap_steps_bitwise_monolithic(name, overlap_steps):
    devices, het, opt, modes = STEPS[name]
    ref = overlap_steps[f"{name}/{modes[0]}"]
    assert len({r["checksum"] for r in ref}) == 1        # equal ranks
    for mode in modes[1:]:
        got = overlap_steps[f"{name}/{mode}"]
        for g, w in zip(got, ref):
            assert [m["loss"] for m in g["metrics"]] == \
                [m["loss"] for m in w["metrics"]], (name, mode)
            assert g["checksum"] == w["checksum"], (name, mode)
            gp, wp = _flat(g["params"]), _flat(w["params"])
            for k in wp:
                np.testing.assert_array_equal(gp[k], wp[k], err_msg=k)
            if w["err"] is not None:
                np.testing.assert_array_equal(g["err"], w["err"])
                assert np.any(g["err"])
            if "trust_ratio" in w["metrics"][0]:
                assert [m["trust_ratio"] for m in g["metrics"]] == \
                    [m["trust_ratio"] for m in w["metrics"]]
    if modes[0] != "none":                       # packed on both sides
        for g, w in zip(overlap_steps[f"{name}/{modes[1]}"], ref):
            np.testing.assert_array_equal(g["m"], w["m"])
            np.testing.assert_array_equal(g["v"], w["v"])


# --------------------------------------------------------------------------
# (e) the overlap steps against JAX
# --------------------------------------------------------------------------

# name: (devices, het fields, optimizer fields, int8?)
JAX_CONFIGS = {
    "bucketed_buckets_clip": ((2, 1), dict(
        grad_reduction="bucketed_allreduce", bucket_mb=0.05,
        overlap="buckets"), dict(grad_clip=1.0), False),
    "bucketed_backward_lamb": ((2, 1), dict(
        grad_reduction="bucketed_allreduce", bucket_mb=0.05,
        overlap="backward"), dict(name="lamb"), False),
    "hier_int8_backward_accum2": ((2, 1, 1), dict(
        grad_reduction="hierarchical", compression="int8", bucket_mb=0.05,
        overlap="backward", accum_steps=2), {}, True),
    "hier_int8_buckets_lamb_clip": ((2, 1, 1), dict(
        grad_reduction="hierarchical", compression="int8", bucket_mb=0.05,
        overlap="buckets"), dict(name="lamb", grad_clip=1.0), True),
    "hier_fp32_backward_dead_rank": ((2, 2, 1), dict(
        grad_reduction="hierarchical", bucket_mb=0.02, overlap="backward",
        accum_steps=2, capacities=(2.0, 1.0, 1.0, 0.0)), {}, False),
}

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

for name, (devices, het, opt) in spec.items():
    axes = ("data", "model") if len(devices) == 2 else ("pod", "data",
                                                        "model")
    mesh = jax.make_mesh(tuple(devices), axes,
                         axis_types=(AxisType.Auto,) * len(devices))
    mc = dataclasses.replace(cfgs.smoke_config("olmo-1b"),
                             compute_dtype="float32", scan_layers=False)
    if "capacities" in het:
        het["capacities"] = tuple(het["capacities"])
    tcfg = cfgs.TrainConfig(
        model=mc, shape=cfgs.ShapeConfig("t", SEQ, GLOBAL, "train"),
        het=cfgs.HetConfig(quantize_impl="reference", **het),
        optimizer=cfgs.OptimizerConfig(**{**OPT, **opt}),
        label_smoothing=0.1)
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
            mets.append({k: float(v) for k, v in met.items()})
    out[name + "/metrics"] = np.array(json.dumps(mets))
    flat(jax.tree.map(np.asarray, state.params), name + "/params")
    out[name + "/m"] = np.asarray(state.opt.m)
    out[name + "/v"] = np.asarray(state.opt.v)
    if not (isinstance(state.err, tuple) and state.err == ()):
        out[name + "/err"] = np.asarray(state.err)
np.savez(OUT, **out)
"""


def _sub(npz, prefix):
    tree = {}
    for key, v in npz.items():
        if key.startswith(prefix + "/"):
            node = tree
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            if parts[-1] != "__empty__":
                node[parts[-1]] = v
    return tree


@pytest.fixture(scope="module")
def jax_overlap(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_overlap")
    inputs, spec, plans = {}, {}, {}
    for name, (devices, het, opt, _) in JAX_CONFIGS.items():
        plan, batches = _batches(name, devices, het, 100 + len(name))
        plans[name] = (plan, batches)
        spec[name] = [list(devices), het, opt]
        for i, b in enumerate(batches):
            for k, v in b.items():
                inputs[f"{name}/b{i}/{k}"] = v
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs)
    opt = dict(lr=1e-3, warmup_steps=1, schedule="constant", total_steps=3,
               grad_clip=0.0)
    prog = (f"IN = {str(src)!r}\nOUT = {str(dst)!r}\n"
            f"SPEC = {json.dumps(spec)!r}\nSEQ, GLOBAL = {SEQ}, {GLOBAL}\n"
            f"OPT = {opt!r}\n" + textwrap.dedent(JAX_CHILD))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    jout = dict(np.load(dst))
    runs = {}
    for name, (devices, het, opt_, _) in JAX_CONFIGS.items():
        plan, batches = plans[name]
        runs.setdefault(_world(devices), []).append(
            (name, devices, {k: v for k, v in het.items() if k != "overlap"},
             opt_, het["overlap"], batches, plan.buffer_rows,
             _sub(jout, name + "/params0")))
    return jout, _spawn_runs(runs)


def _stack_close(got, want, lo, tol, what):
    """Packed stacks, each stream leaf within ``tol`` of its largest
    magnitude."""
    g, w = got.reshape(-1), want.reshape(-1)
    for off, n in zip(lo.offsets, lo.sizes):
        ref = w[off:off + n]
        np.testing.assert_allclose(
            g[off:off + n], ref, rtol=0,
            atol=tol * max(float(np.abs(ref).max()), 1e-30), err_msg=what)
    assert not np.any(g[lo.total:])                 # the padding


@pytest.mark.parametrize("name", list(JAX_CONFIGS))
def test_overlap_steps_match_jax(name, jax_overlap):
    devices, het, opt, int8 = JAX_CONFIGS[name]
    jout, port = jax_overlap
    ranks = port[name]
    assert len({r["checksum"] for r in ranks}) == 1
    want = json.loads(str(jout[name + "/metrics"]))
    got = ranks[0]["metrics"]
    tol = INT8 if int8 else {"loss": RTOL, "grad_norm": GNORM_RTOL,
                             "leaf": LEAF_TOL}
    assert [set(m) for m in got] == [set(m) for m in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=tol["loss"])
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=tol["grad_norm"])
        assert g["weight"] == w["weight"]
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-7)
        if "trust_ratio" in w:
            np.testing.assert_allclose(g["trust_ratio"], w["trust_ratio"],
                                       rtol=tol["grad_norm"])
    gp, wp = _flat(ranks[0]["params"]), _flat(_sub(jout, name + "/params"))
    assert set(gp) == set(wp)
    for k, w in wp.items():
        np.testing.assert_allclose(
            gp[k], w, rtol=0,
            atol=tol["leaf"] * max(float(np.abs(w).max()), 1e-30),
            err_msg=k)
    mc = _smoke()
    tcfg = _tcfg({k: v for k, v in het.items() if k != "overlap"}, opt,
                 het["overlap"])
    lo = tsteps.bucket_layout(tcfg, mesh_mod.unjoined(devices, _axes(
        devices)), tbuild(mc, "cpu").init_params(0))
    for what in ("m", "v"):
        assert ranks[0][what].shape == jout[f"{name}/{what}"].shape
        _stack_close(ranks[0][what], jout[f"{name}/{what}"], lo,
                     tol["leaf"], f"{name} {what}")
    if f"{name}/err" in jout:
        jerr = jout[f"{name}/err"]
        for pod, r in enumerate(ranks):               # data = 1: rank = pod
            g, w = r["err"], jerr[pod]
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            share = np.mean(np.abs(g - w) > 1e-3 * np.abs(w).max())
            assert rel <= ERR_TOL[0] and share <= ERR_TOL[1], (rel, share)
