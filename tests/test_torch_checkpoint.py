"""repro_torch's checkpoints against the JAX package's (CPU): one on-disk
format, both ways.

  (a) the layout record: ``layout_record`` / ``layout_fingerprint`` of
      the smoke olmo-1b tree equal JAX's at two ``bucket_mb`` and 1, 2
      and 4 ranks, and the leaf keys equal JAX's path keys;
  (b) keys and the repack: the port's restore template
      (``launch/steps.py::state_shapes``) has JAX's ``state_shapes``
      keys, order, shapes and dtypes and ``checkpoint_format`` JAX's
      block, under allreduce, bucketed hierarchical int8 (a flat
      residual), per-leaf hierarchical int8 and ``overlap="buckets"``
      (packed moments and the grid's layout record); ``adapt_arrays`` gives
      bitwise-equal dicts on the same inputs: the residual 2 -> 1 and
      2 -> 3 ranks (its sum conserved bitwise) and packed moments into
      pytree moments;
  (c) the format both ways: a state written by JAX's
      ``CheckpointManager`` (v3, two hosts; packed moments too)
      restores in the port bitwise,
      one written by the port restores in JAX's with JAX's template
      bitwise, and a version-2 checkpoint written by JAX restores in
      the port bitwise; both managers behave alike on a tampered shard (fall
      back to the previous step), a half-written ``.tmp`` (skipped),
      rotation, a lossy cast (refused) and fault hooks (a transient one
      retried, a persistent one raised by ``wait``);
  (d) the step after a restore: a port checkpoint written by two gloo
      ranks at step 2 (hierarchical int8 with error feedback, and plain
      all-reduce; olmo-1b smoke at fp32) restores bitwise into the port,
      and the next step from it matches JAX's ``build_train_step`` on
      the same checkpoint restored by JAX's manager (two forced host
      devices, Auto axes, one JAX child process) to the tolerances of
      ``test_torch_dist_train.py`` (fp32: loss 1e-5 relative, grad norm
      1e-4, each leaf 1e-4 of its largest magnitude; int8: 1e-4, 1e-2,
      2e-2, and the residual after one step 0.03 relative L2 with at
      most 0.5% of elements off by more than 1e-3 of its largest).
"""
import dataclasses
import json
import logging
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint import checkpoint as jckpt
from repro.checkpoint import repack as jrepack
from repro.configs import base as jcfgs
from repro.core import buckets as jbkt
from repro.core import capacity as jcap
from repro.launch import steps as jsteps
from repro.models.model import build_model as jbuild
from repro.optim import adam as jadam
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.checkpoint import repack as trepack
from repro_torch.configs import base as tcfgs
from repro_torch.core import buckets as tbkt
from repro_torch.core import capacity as tcap
from repro_torch.core import dummy as tdummy
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as tsteps
from repro_torch.models import convert
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim import adam as tadam

REPO = Path(__file__).resolve().parent.parent

# name: (devices, het fields)
CONFIGS = {
    "allreduce": ((1, 1), {}),
    "hier_int8_flat": ((2, 1, 1), dict(grad_reduction="hierarchical",
                                       compression="int8", bucket_mb=0.05)),
    "hier_int8_per_leaf": ((2, 1, 1), dict(grad_reduction="hierarchical",
                                           compression="int8",
                                           bucket_mb=0.0)),
    "hier_int8_flat_2x2": ((2, 2, 1), dict(grad_reduction="hierarchical",
                                           compression="int8",
                                           bucket_mb=0.02)),
    # overlap="buckets": the moments packed, (num_buckets, bucket_elems)
    "hier_int8_overlap": ((2, 1, 1), dict(grad_reduction="hierarchical",
                                          compression="int8", bucket_mb=0.05,
                                          overlap="buckets")),
}


def _axes(devices):
    return ("data", "model") if len(devices) == 2 else ("pod", "data",
                                                        "model")


def _cfgs(het):
    jtc = jcfgs.TrainConfig(model=jcfgs.smoke_config("olmo-1b"),
                            het=jcfgs.HetConfig(**het))
    ttc = tcfgs.TrainConfig(model=tcfgs.smoke_config("olmo-1b"),
                            het=tcfgs.HetConfig(**het))
    return jtc, ttc


def _jax_cell(devices, het):
    jtc, _ = _cfgs(het)
    return jbuild(jtc.model), jtc, AbstractMesh(devices, _axes(devices))


def _torch_cell(devices, het):
    _, ttc = _cfgs(het)
    return (tbuild(ttc.model, "cpu"), ttc,
            mesh_mod.unjoined(devices, _axes(devices)))


# --------------------------------------------------------------------------
# (a) the layout record
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bucket_mb", [0.05, 0.02])
def test_layout_record_and_fingerprint_match_jax(bucket_mb):
    cfg = jcfgs.smoke_config("olmo-1b")
    jparams = jax.eval_shape(jbuild(cfg).init_params, jax.random.PRNGKey(0))
    tparams = tbuild(tcfgs.smoke_config("olmo-1b"), "cpu").init_params(0)
    jpaths = [jrepack.path_key(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]
    tpaths = list(trepack.flatten_with_paths(
        convert.params_to_host(tparams)))
    assert tpaths == jpaths
    for ranks in (1, 2, 4):
        jlo = jbkt.build_layout(jparams, bucket_mb=bucket_mb,
                                multiple_of=ranks * 256)
        tlo = tbkt.build_layout(tparams, bucket_mb=bucket_mb,
                                multiple_of=ranks * 256)
        for kw in ({}, {"leaf_paths": jpaths, "hosts": ranks}):
            jrec = jbkt.layout_record(jlo, **kw)
            trec = tbkt.layout_record(tlo, **kw)
            assert trec == jrec
            assert tbkt.layout_fingerprint(json.loads(json.dumps(trec))) \
                == jrec["fingerprint"]
        back = tbkt.layout_from_record(trec)
        assert back == tlo
    with pytest.raises(ValueError, match="newer"):
        tbkt.layout_from_record({**trec, "version": 999})


# --------------------------------------------------------------------------
# (b) keys and the repack
# --------------------------------------------------------------------------


def _specs(tree):
    return [(k, tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in tree.items()]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_checkpoint_template_matches_jax_state_shapes(name):
    devices, het = CONFIGS[name]
    jmodel, jtc, jmesh = _jax_cell(devices, het)
    tmodel, ttc, tmesh = _torch_cell(devices, het)
    jtpl = jrepack.flatten_with_paths(jsteps.state_shapes(jmodel, jtc,
                                                          jmesh))
    ttpl = trepack.flatten_with_paths(tsteps.state_shapes(tmodel, ttc,
                                                          tmesh))
    assert _specs(ttpl) == _specs(jtpl)
    assert tsteps.checkpoint_format(tmodel, ttc, tmesh) == \
        jsteps.checkpoint_format(jmodel, jtc, jmesh)
    if het.get("compression") == "int8":
        assert any(k == "err" or k.startswith("err/") for k in ttpl)


def _residual_case(seed):
    """Two ranks' flat residual of the smoke grid, and templates for 1
    and 3 ranks, flat and per leaf."""
    jparams = jax.eval_shape(jbuild(jcfgs.smoke_config("olmo-1b")).init_params,
                             jax.random.PRNGKey(0))
    lo = jbkt.build_layout(jparams, bucket_mb=0.02, multiple_of=512)
    rng = np.random.default_rng(seed)
    err = rng.standard_normal((2, lo.num_buckets, lo.bucket_elems),
                              dtype=np.float32)
    err.reshape(2, -1)[:, lo.total:] = 0.0
    return jparams, lo, err


def _tpl(jtree, ranks):
    """The same template twice: JAX ShapeDtypeStructs and the port's
    ShapeDtype, with a per-leaf (ranks, *leaf) residual."""
    j = jax.tree.map(lambda s: jax.ShapeDtypeStruct((ranks,) + s.shape,
                                                    np.float32), jtree)
    t = jax.tree.map(lambda s: trepack.ShapeDtype((ranks,) + s.shape,
                                                  np.dtype(np.float32)),
                     jtree)
    return j, t


def _adapt_both(arrays, jtpl, ttpl, fmt=None):
    got = trepack.adapt_arrays(dict(arrays), ttpl, fmt)
    want = jrepack.adapt_arrays(dict(arrays), jtpl, fmt)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


@pytest.mark.parametrize("ranks", [1, 2, 3])
def test_adapt_arrays_residual_across_rank_counts_matches_jax(ranks):
    jparams, lo, err = _residual_case(ranks)
    nb, be = lo.num_buckets, lo.bucket_elems
    arrays = {"params/x": np.ones(3, np.float32), "err": err}
    # flat template
    got = _adapt_both(arrays,
                      {"params": {"x": jax.ShapeDtypeStruct((3,), np.float32)},
                       "err": jax.ShapeDtypeStruct((ranks, nb, be),
                                                   np.float32)},
                      {"params": {"x": trepack.ShapeDtype((3,), np.float32)},
                       "err": trepack.ShapeDtype((ranks, nb, be),
                                                 np.float32)})
    np.testing.assert_array_equal(got["err"].sum(axis=0), err.sum(axis=0))
    if ranks == 2:
        np.testing.assert_array_equal(got["err"], err)   # identity
    # per-leaf template (the legacy walk's mirror)
    jt, tt = _tpl(jparams, ranks)
    got = _adapt_both(arrays, {"err": jt}, {"err": tt})
    flat = np.concatenate([got[k].reshape(ranks, -1) for k in got
                           if k.startswith("err/")], axis=1)
    np.testing.assert_array_equal(flat.sum(axis=0),
                                  err.reshape(2, -1)[:, :lo.total].sum(0))
    # a template without a residual drops it; one with a residual and a
    # checkpoint without starts from zeros
    got = _adapt_both({"params/x": np.ones(3, np.float32)},
                      {"err": jax.ShapeDtypeStruct((ranks, nb, be),
                                                   np.float32)},
                      {"err": trepack.ShapeDtype((ranks, nb, be),
                                                 np.float32)})
    assert not got["err"].any()


def test_adapt_arrays_packed_moments_into_pytree_matches_jax():
    """A JAX overlap checkpoint's packed opt/m and opt/v unpack into the
    port's pytree moments: the stream follows the sorted flatten
    order."""
    jparams = jax.eval_shape(jbuild(jcfgs.smoke_config("olmo-1b")).init_params,
                             jax.random.PRNGKey(0))
    lo = jbkt.build_layout(jparams, bucket_mb=0.02, multiple_of=512)
    rec = jbkt.layout_record(lo, hosts=2)
    fmt = {"version": 3, "packed_fields": ["opt/m", "opt/v"],
           "layout": rec, "state": "packed"}
    rng = np.random.default_rng(3)
    arrays = {"opt/step": np.int32(5)}
    for g in ("opt/m", "opt/v"):
        a = rng.standard_normal((lo.num_buckets, lo.bucket_elems),
                                dtype=np.float32)
        a.reshape(-1)[lo.total:] = 0.0
        arrays[g] = a
    jt = {"opt": jadam.AdamState(
        step=jax.ShapeDtypeStruct((), np.int32), m=jparams, v=jparams)}
    spec = jax.tree.map(lambda s: trepack.ShapeDtype(s.shape,
                                                     np.dtype(s.dtype)),
                        jparams)
    tt = {"opt": tadam.AdamState(
        step=trepack.ShapeDtype((), np.dtype(np.int32)), m=spec, v=spec)}
    got = _adapt_both(arrays, jt, tt, fmt)
    stream = np.concatenate([got[k].reshape(-1) for k in got
                             if k.startswith("opt/m/")])
    np.testing.assert_array_equal(stream,
                                  arrays["opt/m"].reshape(-1)[:lo.total])
    with pytest.raises(ValueError, match="nonzero data"):
        bad = dict(arrays)
        bad["opt/m"] = np.ones_like(arrays["opt/m"])
        trepack.adapt_arrays(bad, tt, fmt)


def test_adapt_arrays_checks_format_blocks_as_jax_does():
    """A pipeline stage record is validated (a malformed one fails the
    restore), and a newer format version is refused, in both packages
    with the same message."""
    plan = {"capacities": [1.0, 1.0], "rows_per_rank": [1, 1],
            "buffer_rows": 1, "global_rows": 2}
    arrays = {"params/x": np.ones(2, np.float32)}
    for fmt in ({"pipeline": {"num_layers": 2, "plan": plan}},
                {"pipeline": {"num_layers": 3, "plan": plan}},
                {"pipeline": [1, 2]}, {"pipeline": {"plan": plan}},
                {"version": 4}):
        outcome = []
        for mod, leaf in ((jrepack, jax.ShapeDtypeStruct((2,), np.float32)),
                          (trepack, trepack.ShapeDtype((2,), np.float32))):
            try:
                mod.adapt_arrays(dict(arrays), {"params": {"x": leaf}}, fmt)
                outcome.append("ok")
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], fmt
    assert outcome[0].startswith("checkpoint format version 4 is newer")


# --------------------------------------------------------------------------
# (c) the format both ways, and the managers' behaviour
# --------------------------------------------------------------------------


def _host_state(name, seed):
    """A random state in the JAX layout of config ``name``: the JAX
    TrainState (numpy leaves) and the port's with the same arrays."""
    devices, het = CONFIGS[name]
    jmodel, jtc, jmesh = _jax_cell(devices, het)
    shapes = jsteps.state_shapes(jmodel, jtc, jmesh)
    rng = np.random.default_rng(seed)

    def draw(s):
        if np.dtype(s.dtype) == np.int32:
            return np.asarray(rng.integers(0, 100), np.int32)
        return rng.standard_normal(s.shape, dtype=np.float32)

    jstate = jax.tree.map(draw, shapes)
    tstate = tsteps.TrainState(
        params=jstate.params,
        opt=tadam.AdamState(step=jstate.opt.step, m=jstate.opt.m,
                            v=jstate.opt.v),
        err=jstate.err)
    return jstate, tstate, jsteps.checkpoint_format(jmodel, jtc, jmesh)


def _meta(fmt, cap_mod):
    plan = cap_mod.plan_capacities(8, (1.0, 1.0), headroom=1.25)
    return {"epoch": 1, "seed": 0, "plan": plan, "format": dict(fmt),
            "stream": {"epoch": 1, "batch_in_epoch": 3}}


def _flat_equal(got, want):
    g, w = trepack.flatten_with_paths(got), jrepack.flatten_with_paths(want)
    assert list(g) == list(w)
    for k in w:
        assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name", ["hier_int8_flat", "hier_int8_per_leaf",
                                  "hier_int8_flat_2x2",
                                  "hier_int8_overlap"])
def test_jax_checkpoint_restores_in_the_port_and_back_bitwise(name,
                                                              tmp_path):
    devices, het = CONFIGS[name]
    jstate, tstate, fmt = _host_state(name, 1)
    assert fmt["hosts"] == 2
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.CheckpointManager(jdir).save(7, jstate, meta=_meta(fmt, jcap),
                                       block=True)
    tmodel, ttc, tmesh = _torch_cell(devices, het)
    ttpl = tsteps.state_shapes(tmodel, ttc, tmesh)
    got, meta = tckpt.CheckpointManager(jdir).restore(ttpl)
    _flat_equal(got, jstate)
    assert meta["step"] == 7 and meta["stream"]["batch_in_epoch"] == 3
    assert isinstance(meta["plan"], tcap.CapacityPlan)
    assert meta["plan"].rows_per_rank.tolist() == [4, 4]
    # onto the port's device layout: per-layer lists, pod 0's residual
    dev_state = tsteps.state_from_host(got, tmodel, ttc, tmesh)
    back = tsteps.state_to_host(dev_state, ttc, tmesh)
    _flat_equal(back.params, jstate.params)
    _flat_equal(back.opt.m, jstate.opt.m)
    _flat_equal(back.opt.v, jstate.opt.v)
    if het.get("overlap", "none") != "none":    # packed on both sides
        assert fmt["packed_fields"] == ["opt/m", "opt/v"]
        assert isinstance(dev_state.opt.m, torch.Tensor) and \
            dev_state.opt.m.shape == jstate.opt.m.shape
    err0 = trepack.flatten_with_paths(back.err)
    for k, v in jrepack.flatten_with_paths(jstate.err).items():
        np.testing.assert_array_equal(err0[k][0], np.asarray(v)[0])
    # the port writes, JAX reads with JAX's template
    mgr = tckpt.CheckpointManager(tdir)
    mgr.save(9, tstate, meta=_meta(fmt, tcap))
    mgr.wait()
    man = mgr.verify(9)
    assert man["hosts"] == 2 and set(man["files"]) == {
        "arrays_host0.npz", "arrays_host1.npz", "meta.json"}
    jmodel, jtc, jmesh = _jax_cell(devices, het)
    jgot, jmeta = jckpt.CheckpointManager(tdir).restore(
        jsteps.state_shapes(jmodel, jtc, jmesh))
    _flat_equal(tstate, jax.tree.map(np.asarray, jgot))
    assert jmeta["step"] == 9 and jmeta["stream"] == {"epoch": 1,
                                                      "batch_in_epoch": 3}
    assert jmeta["plan"].rows_per_rank.tolist() == [4, 4]
    # the same manifest layout: each file holds the same keys and rows
    jman = json.loads((tmp_path / "jax" / "step_0000000007" /
                       "manifest.json").read_text())
    assert {f: r.get("keys") for f, r in man["files"].items()} == \
        {f: r.get("keys") for f, r in jman["files"].items()}


def test_jax_v2_checkpoint_restores_in_the_port_bitwise(tmp_path):
    """Version 2 (one gathered ``arrays.npz``, no manifest), as JAX's
    ``save(format_version=2)`` writes it, restores in the port, bitwise
    on every leaf."""
    devices, het = CONFIGS["hier_int8_flat"]
    jstate, _, fmt = _host_state("hier_int8_flat", 1)
    jckpt.CheckpointManager(str(tmp_path)).save(
        4, jstate, meta=_meta(fmt, jcap), block=True, format_version=2)
    step_dir = tmp_path / "step_0000000004"
    assert sorted(p.name for p in step_dir.iterdir()) == [
        "_DONE", "arrays.npz", "meta.json"]
    tmodel, ttc, tmesh = _torch_cell(devices, het)
    got, meta = tckpt.CheckpointManager(str(tmp_path)).restore(
        tsteps.state_shapes(tmodel, ttc, tmesh))
    _flat_equal(got, jstate)
    assert meta["step"] == 4 and meta["format"]["version"] == 2
    assert meta["plan"].rows_per_rank.tolist() == [4, 4]


def _small_state(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 3)).astype(dtype),
                       "b": rng.standard_normal(3).astype(dtype)},
            "err": rng.standard_normal((2, 2, 8)).astype(np.float32)}


def _small_tpl(mod, dtype=np.float32):
    mk = (jax.ShapeDtypeStruct if mod is jckpt
          else lambda s, d: trepack.ShapeDtype(s, np.dtype(d)))
    return {"params": {"w": mk((4, 3), dtype), "b": mk((3,), dtype)},
            "err": mk((2, 2, 8), np.float32)}


def _behaviour(mod, root, corrupt):
    """One scenario through one package's manager; returns what it saw."""
    fmt = {"hosts": 2}
    seen = {}
    mgr = mod.CheckpointManager(str(root / "a"), keep=5)
    for s in (1, 2):
        mgr.save(s, _small_state(s), meta={"format": dict(fmt)})
        mgr.wait()
    d2 = root / "a" / "step_0000000002"
    shard = d2 / "arrays_host1.npz"
    if corrupt == "truncate":
        shard.write_bytes(shard.read_bytes()[:shard.stat().st_size // 2])
    elif corrupt == "flip":
        data = bytearray(shard.read_bytes())
        data[len(data) // 2] ^= 0xFF
        shard.write_bytes(bytes(data))
    else:
        (d2 / "manifest.json").unlink()
    try:
        mgr.restore(_small_tpl(mod), step=2)
        seen["explicit"] = "restored"
    except mod.CheckpointCorruptError:
        seen["explicit"] = "corrupt"
    got, meta = mgr.restore(_small_tpl(mod))
    seen["fallback_step"] = meta["step"]
    seen["fallback_w"] = np.asarray(got["params"]["w"]).tolist()
    # a half-written step (no _DONE) is never a candidate
    os.makedirs(root / "a" / "step_0000000003.tmp")
    os.makedirs(root / "a" / "step_0000000004")
    seen["steps"] = mgr.all_steps()
    # rotation
    rot = mod.CheckpointManager(str(root / "r"), keep=2)
    for s in (1, 2, 3, 4):
        rot.save(s, _small_state(s))
        rot.wait()
    seen["rotated"] = rot.all_steps()
    # a lossy cast is refused, a widening one is not
    try:
        rot.restore(_small_tpl(mod, np.float16))
        seen["lossy"] = "restored"
    except ValueError as e:
        seen["lossy"] = str(e).split(":")[0]
    got, _ = rot.restore(_small_tpl(mod, np.float64))
    seen["widened"] = str(np.asarray(got["params"]["w"]).dtype)
    # fault hooks: a transient failure is retried, a persistent one
    # raised by wait()
    calls = []

    def transient(step, path):
        calls.append(step)
        if len(calls) == 1:
            raise OSError("injected")

    fm = mod.CheckpointManager(str(root / "f"), io_backoff_s=0.0,
                               fault_hook=transient)
    fm.save(5, _small_state(5))
    fm.wait()
    seen["transient"] = (fm.all_steps(), calls)

    def persistent(step, path):
        raise OSError("always")

    pm = mod.CheckpointManager(str(root / "p"), io_backoff_s=0.0,
                               fault_hook=persistent)
    pm.save(6, _small_state(6))
    try:
        pm.wait()
        seen["persistent"] = "ok"
    except OSError as e:
        seen["persistent"] = str(e)
    seen["persistent_steps"] = pm.all_steps()
    return seen


@pytest.mark.parametrize("corrupt", ["truncate", "flip", "no_manifest"])
def test_both_managers_behave_alike_on_faults(tmp_path, corrupt, caplog):
    with caplog.at_level(logging.WARNING):
        want = _behaviour(jckpt, tmp_path / "jax", corrupt)
        got = _behaviour(tckpt, tmp_path / "torch", corrupt)
    assert got == want
    assert want["explicit"] == "corrupt" and want["fallback_step"] == 1
    assert want["steps"] == [1, 2] and want["rotated"] == [3, 4]
    assert want["lossy"] == "lossy dtype cast for 'params/b'"
    assert want["transient"] == ([5], [5, 5])
    assert want["persistent"] == "always" and want["persistent_steps"] == []
    assert any("falling back" in r.message for r in caplog.records
               if r.name == "repro_torch.checkpoint.checkpoint")


def test_port_refuses_bf16_state_and_unserializable_meta(tmp_path):
    with pytest.raises(ValueError, match="bfloat16"):
        convert.params_to_host({"w": torch.zeros(2, dtype=torch.bfloat16)})
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, _small_state(1), meta={"bad": object()})
    with pytest.raises(TypeError, match="not JSON-serializable"):
        mgr.wait()
    assert mgr.all_steps() == []
    # keys escape '/' and '%' as JAX's do, so no two leaves collide
    keys = list(trepack.flatten_with_paths(
        {"a/b": {"c": 1}, "a": {"b/c": 2, "%": 3}, "z": [4, (5,)]}))
    assert keys == list(jrepack.flatten_with_paths(
        {"a/b": {"c": 1}, "a": {"b/c": 2, "%": 3}, "z": [4, (5,)]}))


# --------------------------------------------------------------------------
# (d) the step after a restore, against JAX
# --------------------------------------------------------------------------

SEQ, GLOBAL = 12, 8
OPT = dict(lr=1e-3, warmup_steps=1, schedule="constant", total_steps=3)
# name: (devices, het fields, int8?)
STEP_CONFIGS = {
    "hier_int8": ((2, 1, 1), dict(grad_reduction="hierarchical",
                                  compression="int8", bucket_mb=0.05), True),
    "allreduce": ((2, 1), {}, False),
}
FP32_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "leaf": 1e-4}
INT8_TOL = {"loss": 1e-4, "grad_norm": 1e-2, "leaf": 2e-2}
ERR_TOL = (0.03, 0.005)            # relative L2, share of elements off


def _step_tcfg(het):
    mc = dataclasses.replace(tcfgs.smoke_config("olmo-1b"),
                             compute_dtype="float32",
                             attention_impl="kernel")
    return tcfgs.TrainConfig(
        model=mc, shape=tcfgs.ShapeConfig("t", SEQ, GLOBAL, "train"),
        het=tcfgs.HetConfig(quantize_impl="pallas", **het),
        optimizer=tcfgs.OptimizerConfig(**OPT), label_smoothing=0.1)


def _step_batches():
    """Three packed global batches (two ranks' buffers) from a seed."""
    plan = tcap.plan_capacities(GLOBAL, (1.0, 1.0), headroom=1.25)
    rng = np.random.default_rng(21)
    vocab = tcfgs.smoke_config("olmo-1b").vocab_size
    out = []
    for _ in range(3):
        samples = {k: rng.integers(0, vocab, (GLOBAL, SEQ)).astype(np.int32)
                   for k in ("inputs", "labels")}
        out.append(tdummy.pack_global_batch(samples, plan))
    return plan, out


def ckpt_rank(rank, world, init_method, root):
    """Each config on two gloo ranks: two steps, a checkpoint (rank 0
    writes, every pod's residual gathered), a restore from it on every
    rank, checked bitwise against the state it came from, and the third
    step from the restored state."""
    mesh_mod.share_cpu(world)
    plan, batches = _step_batches()
    b = plan.buffer_rows
    out = {}
    for name, (devices, het, _) in STEP_CONFIGS.items():
        mesh = mesh_mod.init(devices, _axes(devices), rank, init_method,
                             "cpu")
        tcfg = _step_tcfg(het)
        model = tbuild(tcfg.model, "cpu")
        step = tsteps.build_train_step(model, tcfg, mesh)
        state = tsteps.init_train_state(model, tcfg, mesh=mesh)

        def mine(batch):
            return {k: torch.from_numpy(v[rank * b:(rank + 1) * b])
                    for k, v in batch.items()}

        for batch in batches[:2]:
            state, _ = step(state, mine(batch))
        host = tsteps.state_to_host(state, tcfg, mesh)
        ck = os.path.join(root, name)
        if host is not None:
            mgr = tckpt.CheckpointManager(ck)
            mgr.save(2, host, meta={
                "plan": plan,
                "format": tsteps.checkpoint_format(model, tcfg, mesh)})
            mgr.wait()
        mesh.world.all_reduce(torch.zeros(1))           # written
        got, meta = tckpt.CheckpointManager(ck).restore(
            tsteps.state_shapes(model, tcfg, mesh))
        restored = tsteps.state_from_host(got, model, tcfg, mesh)
        same = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(state.params) + tree_leaves(state.opt.m) +
            tree_leaves(state.opt.v) + tree_leaves(state.err),
            tree_leaves(restored.params) + tree_leaves(restored.opt.m) +
            tree_leaves(restored.opt.v) + tree_leaves(restored.err)))
        same = same and int(restored.opt.step) == int(state.opt.step) == 2
        restored, met = step(restored, mine(batches[2]))
        err = restored.err
        out[name] = {
            "bitwise_restore": same,
            "metrics": [float(met[k]) for k in ("loss", "grad_norm",
                                                "weight", "lr")],
            "err": (err.numpy().copy() if isinstance(err, torch.Tensor)
                    else None),
            "params": (convert.params_to_numpy(restored.params)
                       if rank == 0 else None),
            "m": convert.params_to_numpy(restored.opt.m) if rank == 0
            else None}
    mesh_mod.destroy(mesh)
    return out


JAX_CHILD = """
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import compat
from repro.checkpoint import repack
from repro.checkpoint.checkpoint import CheckpointManager
from repro.configs import base as cfgs
from repro.launch import steps
from repro.launch.sharding import named
from repro.models.model import build_model

spec = json.loads(SPEC)
data = dict(np.load(IN))
out = {}

def flat(tree, prefix):
    for k, v in repack.flatten_with_paths(tree).items():
        out[prefix + "/" + k] = np.asarray(v)

for name, (devices, het) in spec.items():
    axes = ("data", "model") if len(devices) == 2 else ("pod", "data",
                                                        "model")
    mesh = jax.make_mesh(tuple(devices), axes,
                         axis_types=(AxisType.Auto,) * len(devices))
    mc = dataclasses.replace(cfgs.smoke_config("olmo-1b"),
                             compute_dtype="float32")
    tcfg = cfgs.TrainConfig(
        model=mc, shape=cfgs.ShapeConfig("t", SEQ, GLOBAL, "train"),
        het=cfgs.HetConfig(quantize_impl="reference", **het),
        optimizer=cfgs.OptimizerConfig(**OPT), label_smoothing=0.1)
    model = build_model(mc)
    with compat.set_mesh(mesh):
        host, meta = CheckpointManager(ROOT + "/" + name).restore(
            steps.state_shapes(model, tcfg, mesh))
        state = jax.device_put(host, named(
            mesh, steps.state_specs(model, tcfg, mesh)))
        step = steps.build_train_step(model, tcfg, mesh)
        b = {k: jnp.asarray(data[k]) for k in ("inputs", "labels",
                                                "weights")}
        state, met = step(state, b)
    out[name + "/metrics"] = np.array(
        [float(met[k]) for k in ("loss", "grad_norm", "weight", "lr")])
    out[name + "/step"] = np.asarray(int(meta["step"]))
    flat(jax.tree.map(np.asarray, state.params), name + "/params")
    flat(jax.tree.map(np.asarray, state.opt.m), name + "/m")
    if not (isinstance(state.err, tuple) and state.err == ()):
        out[name + "/err"] = np.asarray(state.err)
np.savez(OUT, **out)
"""


def test_step_after_a_restore_matches_jax_on_the_same_checkpoint(tmp_path):
    root = str(tmp_path / "ck")
    ranks = mesh_mod.spawn(ckpt_rank, 2, (root,), timeout_s=600)
    _, batches = _step_batches()
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **batches[2])
    spec = {name: [list(d), het] for name, (d, het, _)
            in STEP_CONFIGS.items()}
    prog = (f"IN = {str(src)!r}\nOUT = {str(dst)!r}\nROOT = {root!r}\n"
            f"SPEC = {json.dumps(spec)!r}\nSEQ, GLOBAL = {SEQ}, {GLOBAL}\n"
            f"OPT = {OPT!r}\n" + textwrap.dedent(JAX_CHILD))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    jout = dict(np.load(dst))
    for name, (devices, het, int8) in STEP_CONFIGS.items():
        got = [r[name] for r in ranks]
        assert all(r["bitwise_restore"] for r in got), name
        assert got[0]["metrics"] == got[1]["metrics"]
        assert int(jout[name + "/step"]) == 2
        tol = INT8_TOL if int8 else FP32_TOL
        want = jout[name + "/metrics"]
        m = np.array(got[0]["metrics"])
        np.testing.assert_allclose(m[0], want[0], rtol=tol["loss"])
        np.testing.assert_allclose(m[1], want[1], rtol=tol["grad_norm"])
        assert m[2] == want[2]                                  # weight
        np.testing.assert_allclose(m[3], want[3], rtol=1e-7)    # lr
        for what, tree in (("params", got[0]["params"]),
                           ("m", got[0]["m"])):
            flat = trepack.flatten_with_paths(tree)
            keys = [k[len(name) + len(what) + 2:] for k in jout
                    if k.startswith(f"{name}/{what}/")]
            assert sorted(flat) == sorted(keys)
            for k in keys:
                w = jout[f"{name}/{what}/{k}"]
                atol = tol["leaf"] * max(float(np.abs(w).max()), 1e-30)
                np.testing.assert_allclose(flat[k], w, rtol=0, atol=atol,
                                           err_msg=f"{name} {what} {k}")
        if not int8:
            assert got[0]["err"] is None and name + "/err" not in jout
            continue
        jerr = jout[name + "/err"]
        for pod, r in enumerate(got):                  # data = 1: rank = pod
            g, w = r["err"], jerr[pod]
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            share = np.mean(np.abs(g - w) > 1e-3 * np.abs(w).max())
            assert rel <= ERR_TOL[0] and share <= ERR_TOL[1], (pod, rel,
                                                               share)


def test_port_npz_writer_and_reader_match_numpy(tmp_path):
    """The port's shard files are ``np.savez`` files (``np.load`` reads
    them), and the port's reader gives what ``np.load`` gives on each:
    C- and Fortran-ordered, strided, 0-d and empty arrays, bitwise."""
    rng = np.random.default_rng(4)
    state = {"params": {"x": rng.random((3, 4), dtype=np.float32),
                        "f": np.asfortranarray(rng.random((2, 3))),
                        "strided": rng.random((6, 5))[::2],
                        "empty": np.zeros((0, 3))},
             "opt": {"step": np.asarray(np.int32(5))},
             "err": rng.standard_normal((2, 2, 8)).astype(np.float32)}
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    mgr.wait()
    shard = str(tmp_path / "step_0000000001" / "arrays_host0.npz")
    got, want = tckpt._read_npz(shard), dict(np.load(shard))
    flat = trepack.flatten_with_paths(state)
    assert list(want) == list(flat)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(want[k], flat[k])
