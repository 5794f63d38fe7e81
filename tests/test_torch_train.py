"""repro_torch's single-device training path against the JAX package.

  (a) ``loss_fn``'s (objective_sum, weight_sum) and every gradient leaf
      vs JAX ``loss_fn`` + ``jax.grad`` (LOCAL_CTX), on the olmo-1b and
      tinyllama-1.1b smoke configs at fp32, through the kernel path (on
      CPU tensors: the kernels' plain versions and recompute backwards)
      and the reference path, with remat none and full;
  (b) ``plan_capacities``, ``pack_global_batch`` and ``HetSampler``
      batches numpy-equal to JAX for capacity splits with a 0;
  (c) ``tests/test_invariant.py`` restated on torch: ``simulate_workers``
      over a capacity split, and ``accumulate_grads`` over the same
      buffers as microbatches, equal the single-process gradient;
  (d) three steps of the port's ``build_train_step`` vs JAX's on a
      (1, 1) mesh of Auto axes: metrics, parameters and AdamW moments,
      with accum 1 and 2;
  (e) the config dataclasses and mode constants equal JAX's field by
      field;
  (f) the train driver: its flags, a CPU smoke run, and no silent drop
      to the CPU when CUDA is asked for.

Parameters are drawn by JAX and carried over (``params_from_jax``);
batches come from a numpy seed. Tolerances (fp32): the same arithmetic
in another order on another backend, so 1e-5 relative on losses,
1e-4 on grad norms; gradients, parameters and moments 1e-4 of each leaf's
largest magnitude (a leaf of the embedding sums ~B*S rank-one terms).
"""
import dataclasses
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import compat
from repro.configs import base as jcfgs
from repro.core import capacity as jcap
from repro.core import dummy as jdummy
from repro.data.dataset import ShardedDataset as JDataset
from repro.data.sampler import HetSampler as JSampler
from repro.data.synthetic import build_synthetic_corpus as jcorpus
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models.blocks import LOCAL_CTX
from repro.models.model import build_model as jbuild
from repro_torch.configs import base as tcfgs
from repro_torch.core import capacity as tcap
from repro_torch.core import dummy as tdummy
from repro_torch.core import weighting as tweighting
from repro_torch.core.accumulate import accumulate_grads, value_and_grad
from repro_torch.data.dataset import ShardedDataset as TDataset
from repro_torch.data.sampler import HetSampler as TSampler
from repro_torch.data.synthetic import build_synthetic_corpus as tcorpus
from repro_torch.kernels.cross_entropy import cross_entropy as tce
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.transformer import tree_leaves as _leaves
from repro_torch.optim import adam as tadam

ARCHS = ["olmo-1b", "tinyllama-1.1b"]
RTOL = 1e-5
GNORM_RTOL = 1e-4         # a root of a sum of ~1e5 squares, another order
LEAF_TOL = 1e-4


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jcfgs.smoke_config(arch),
                             compute_dtype="float32", **kw)
    tc = dataclasses.replace(tcfgs.smoke_config(arch),
                             compute_dtype="float32", **kw)
    return jc, tc


def _jax_params(jmodel, seed=0):
    return jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(seed)))


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict; empty dicts vanish."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_close(port_tree, jax_tree, what):
    got = _flat(params_to_numpy(port_tree))
    want = _flat(jax.tree.map(np.asarray, jax_tree))
    assert set(got) == set(want), what
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (what, path)
        tol = LEAF_TOL * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"{what} {path}")


def _batch(rng, rows, seq, vocab, dummy_rows=1):
    """Random tokens; the last ``dummy_rows`` rows and a few tokens carry
    weight 0."""
    w = (rng.random((rows, seq)) > 0.1).astype(np.float32)
    w[rows - dummy_rows:] = 0.0
    return {"inputs": rng.integers(0, vocab, (rows, seq)).astype(np.int32),
            "labels": rng.integers(0, vocab, (rows, seq)).astype(np.int32),
            "weights": w}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# (a) loss_fn and its gradients
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl,remat", [("kernel", "none"),
                                        ("kernel", "full"),
                                        ("reference", "none")])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, impl, remat):
    jc, tc = _cfgs(arch)
    tc = dataclasses.replace(tc, attention_impl=impl, remat=remat)
    jmodel = jbuild(jc)
    jparams = _jax_params(jmodel)
    batch = _batch(np.random.default_rng(1), 3, 12, jc.vocab_size)

    def jobj(p, b):
        o, w, _ = jmodel.loss_fn(p, b, LOCAL_CTX, label_smoothing=0.1)
        return o, w

    (jo, jw), jg = jax.value_and_grad(jobj, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams), _jb(batch))
    tmodel = tbuild(tc, "cpu")
    params = params_from_jax(jparams, tc, "cpu")
    n_fa = tfa.flash_attention_cuda.launches
    n_ce = tce.cross_entropy_cuda.launches
    (to, tw), tg = value_and_grad(tmodel.loss_fn, params, _tb(batch),
                                  ce_impl=impl, label_smoothing=0.1)
    assert (tfa.flash_attention_cuda.launches, tce.cross_entropy_cuda
            .launches) == (n_fa, n_ce)              # CPU: nothing launched
    np.testing.assert_allclose(float(to), float(jo), rtol=RTOL)
    assert float(tw) == float(jw) == float(batch["weights"].sum())
    _assert_trees_close(tg, jg, f"{arch} grads")
    if tc.tie_embeddings:
        assert "lm_head" not in params
    assert not any(p.requires_grad for p in _leaves(params))


def test_olmo_tree_has_no_norm_leaves_and_converts_both_ways():
    """nonparam_ln: empty norm dicts on both sides, no leaf for AdamW;
    tied embeddings: no lm_head. params_to_numpy inverts the converter."""
    jc, tc = _cfgs("olmo-1b")
    jparams = _jax_params(jbuild(jc))
    params = params_from_jax(jparams, tc, "cpu")
    assert params["final_norm"] == {} and params["layers"][0]["ln1"] == {}
    assert "lm_head" not in params
    tparams = tbuild(tc, "cpu").init_params(0)
    assert len(_leaves(tparams)) == len(_leaves(params)) == \
        1 + tc.num_layers * 7
    assert sum(p.numel() for p in _leaves(tparams)) == tc.param_count()
    back = _flat(params_to_numpy(params))
    want = _flat(jparams)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    state = tadam.init_state(params, tcfgs.OptimizerConfig())
    assert len(_leaves(state.m)) == len(_leaves(params))


# --------------------------------------------------------------------------
# (b) planner, packing and sampler
# --------------------------------------------------------------------------

SPLITS = [(2.0, 1.0, 1.0, 0.0), (3.0, 0.0, 1.0), (1.0,)]


@pytest.mark.parametrize("caps", SPLITS)
def test_plan_pack_and_sampler_match_jax(caps, tmp_path):
    for rows in (8, 13):
        jp = jcap.plan_capacities(rows, caps, headroom=1.25,
                                  round_buffer_to=2)
        tp = tcap.plan_capacities(rows, caps, headroom=1.25,
                                  round_buffer_to=2)
        assert tp.rows_per_rank.tolist() == jp.rows_per_rank.tolist()
        assert (tp.buffer_rows, tp.global_rows) == (jp.buffer_rows,
                                                    jp.global_rows)
        np.testing.assert_array_equal(tp.row_weights(), jp.row_weights())
        assert tcap.plan_record(tp) == jcap.plan_record(jp)
        rng = np.random.default_rng(rows)
        samples = {"inputs": rng.integers(0, 50, (rows, 6)),
                   "labels": rng.integers(0, 50, (rows, 6))}
        tw = (rng.random((rows, 6)) > 0.2).astype(np.float32)
        jpk = jdummy.pack_global_batch(samples, jp, tw)
        tpk = tdummy.pack_global_batch(samples, tp, tw)
        for k in ("inputs", "labels", "weights"):
            np.testing.assert_array_equal(tpk[k], jpk[k])
        back = tdummy.unpack_real_rows(tpk, tp)
        np.testing.assert_array_equal(back["labels"], samples["labels"])
    assert tcap.homogeneous_plan(8, 4).rows_per_rank.tolist() == \
        jcap.homogeneous_plan(8, 4).rows_per_rank.tolist()

    plan_j = jcap.plan_capacities(6, caps, headroom=1.25)
    plan_t = tcap.plan_capacities(6, caps, headroom=1.25)
    js = JSampler(JDataset(jcorpus(str(tmp_path / "j"), num_seqs=40,
                                   seq_len=9, vocab=64, rows_per_shard=16,
                                   seed=3)), plan_j, seed=3)
    ts = TSampler(TDataset(tcorpus(str(tmp_path / "t"), num_seqs=40,
                                   seq_len=9, vocab=64, rows_per_shard=16,
                                   seed=3)), plan_t, seed=3)
    for epoch in (0, 1):
        jbs, tbs = list(js.iter_epoch(epoch)), list(ts.iter_epoch(epoch))
        assert len(jbs) == len(tbs) > 0
        for jb, tb in zip(jbs, tbs):
            assert set(jb) == set(tb)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])


# --------------------------------------------------------------------------
# (c) the HetSeq invariant on torch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("caps", [(2.0, 1.0, 1.0, 0.0), (0.0, 3.0, 1.0)])
def test_simulated_workers_equal_single_process(caps):
    """Any split of the real rows over workers, zero-capacity workers
    running all-dummy buffers, aggregates to the single-process loss and
    gradient over the real rows (kernel path, remat full)."""
    _, tc = _cfgs("olmo-1b", remat="full")
    model = tbuild(dataclasses.replace(tc, attention_impl="kernel"), "cpu")
    params = model.init_params(0)
    rng = np.random.default_rng(11)
    rows, seq = 8, 10
    samples = {"inputs": rng.integers(0, tc.vocab_size, (rows, seq)),
               "labels": rng.integers(0, tc.vocab_size, (rows, seq))}
    (o, w), g = value_and_grad(model.loss_fn, params, _tb({
        **samples, "weights": np.ones((rows, seq), np.float32)}))
    want_loss = tweighting.finalize(o, w)
    want = tweighting.scale_grads(g, w)
    plan = tcap.plan_capacities(rows, caps, headroom=1.25)
    packed = tdummy.pack_global_batch(samples, plan)
    b = plan.buffer_rows
    workers = [_tb({k: v[r * b:(r + 1) * b] for k, v in packed.items()})
               for r in range(plan.num_ranks)]
    assert any(not wb["weights"].any() for wb in workers)   # a dummy rank
    loss, grads = tweighting.simulate_workers(model.loss_fn, params,
                                              workers)
    # the same buffers as accumulation microbatches (delayed update)
    stacked = {k: torch.stack([wb[k] for wb in workers])
               for k in workers[0]}
    acc_grads, acc_loss, acc_w = accumulate_grads(model.loss_fn, params,
                                                  stacked)
    assert float(acc_w) == rows * seq
    for got_loss, got in ((loss, grads), (acc_loss, acc_grads)):
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=RTOL)
        for gl, wl in zip(_leaves(got), _leaves(want)):
            tol = LEAF_TOL * float(wl.abs().max())
            torch.testing.assert_close(gl, wl, rtol=0, atol=tol)


# --------------------------------------------------------------------------
# (d) three train steps against JAX's
# --------------------------------------------------------------------------


def _jax_train(jc, tcfg_j, batches):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jmodel = jbuild(jc)
    metrics = []
    with compat.set_mesh(mesh):
        step = jsteps.build_train_step(jmodel, tcfg_j, mesh)
        state = jsteps.init_train_state(jmodel, tcfg_j, mesh,
                                        jax.random.PRNGKey(0))
        params0 = jax.tree.map(np.asarray, state.params)
        for b in batches:
            state, met = step(state, _jb(b))
            metrics.append({k: float(v) for k, v in met.items()})
    return params0, state, metrics


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, accum):
    jc, tc = _cfgs(arch)
    tc = dataclasses.replace(tc, attention_impl="kernel")
    shape = ("t", 12, 4, "train")
    opt = dict(lr=1e-3, warmup_steps=1, schedule="constant", total_steps=3)
    tcfg_j = jcfgs.TrainConfig(
        model=jc, shape=jcfgs.ShapeConfig(*shape),
        het=jcfgs.HetConfig(accum_steps=accum),
        optimizer=jcfgs.OptimizerConfig(**opt), label_smoothing=0.1)
    tcfg_t = tcfgs.TrainConfig(
        model=tc, shape=tcfgs.ShapeConfig(*shape),
        het=tcfgs.HetConfig(accum_steps=accum),
        optimizer=tcfgs.OptimizerConfig(**opt), label_smoothing=0.1)
    plan = tcap.plan_capacities(4, (1.0,), headroom=1.25,
                                round_buffer_to=accum)
    rng = np.random.default_rng(5 + accum)
    batches = []
    for _ in range(3):
        samples = {k: rng.integers(0, jc.vocab_size, (4, 12)).astype(
            np.int32) for k in ("inputs", "labels")}
        batches.append(tdummy.pack_global_batch(samples, plan))
    assert any((b["weights"] == 0).all(axis=1).any() for b in batches)

    params0, jstate, jmet = _jax_train(jc, tcfg_j, batches)
    model = tbuild(tc, "cpu")
    params = params_from_jax(params0, tc, "cpu")
    state = tsteps.TrainState(params=params, opt=tadam.init_state(
        params, tcfg_t.optimizer), err=())
    step = tsteps.build_train_step(model, tcfg_t)
    for b, want in zip(batches, jmet):
        state, met = step(state, _tb(b))
        got = {k: float(v) for k, v in met.items()}
        assert set(got) == set(want) == {"loss", "weight", "grad_norm",
                                         "lr"}
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=GNORM_RTOL)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-7)
        assert got["weight"] == want["weight"]
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    _assert_trees_close(state.params, jstate.params, "params")
    _assert_trees_close(state.opt.m, jstate.opt.m, "m")
    _assert_trees_close(state.opt.v, jstate.opt.v, "v")


def test_unported_train_modes_raise():
    """Pipeline stages want an unrolled stack (the JAX package's own
    check) and then build; overlap, canonical weighting, LAMB and the
    pipeline stages build and take a finite step."""
    _, tc = _cfgs("olmo-1b")
    model = tbuild(tc, "cpu")
    unrolled = dataclasses.replace(tc, scan_layers=False)
    pipe = tcfgs.HetConfig(accum_steps=2, pipeline_stages=2)
    tsteps.build_train_step(tbuild(unrolled, "cpu"), tcfgs.TrainConfig(
        model=unrolled, het=pipe))
    with pytest.raises(ValueError, match="scan_layers"):
        tsteps.build_train_step(model, tcfgs.TrainConfig(model=tc, het=pipe))
    batch = _tb(_batch(np.random.default_rng(4), 4, 8, tc.vocab_size))
    for het, opt in ((dict(overlap="buckets", bucket_mb=1.0,
                           grad_reduction="bucketed_allreduce"), {}),
                     (dict(weighting="canonical"), {}),
                     ({}, dict(name="lamb"))):
        tcfg = tcfgs.TrainConfig(model=tc, het=tcfgs.HetConfig(**het),
                                 optimizer=tcfgs.OptimizerConfig(**opt))
        state = tsteps.init_train_state(model, tcfg)
        state, met = tsteps.build_train_step(model, tcfg)(state, batch)
        assert np.isfinite(float(met["loss"])) and int(state.opt.step) == 1
        assert ("trust_ratio" in met) == (opt.get("name") == "lamb")
    with pytest.raises(ValueError, match="bucket_mb"):
        het = tcfgs.HetConfig(grad_reduction="bucketed_allreduce")
        tsteps.build_train_step(model, tcfgs.TrainConfig(model=tc, het=het))
    with pytest.raises(ValueError, match="remat 'dots'"):
        m = tbuild(dataclasses.replace(tc, remat="dots"), "cpu")
        value_and_grad(m.loss_fn, m.init_params(0), _tb(_batch(
            np.random.default_rng(0), 2, 4, tc.vocab_size)))


# --------------------------------------------------------------------------
# (e) configs
# --------------------------------------------------------------------------


def _fields(cls):
    return [(f.name, f.default, f.default_factory)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ShapeConfig", "HetConfig",
                                  "OptimizerConfig", "MeshConfig",
                                  "TrainConfig"])
def test_train_configs_match_jax_field_by_field(name):
    jcls, tcls = getattr(jcfgs, name), getattr(tcfgs, name)
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [f.name for f in tf] == [f.name for f in jf]
    def norm(x):
        return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x

    for a, b in zip(tf, jf):
        assert norm(a.default) == norm(b.default), (name, a.name)
        if a.default_factory is not dataclasses.MISSING:
            assert dataclasses.asdict(a.default_factory()) == \
                dataclasses.asdict(b.default_factory()), (name, a.name)
    for const in ("GRAD_REDUCTION_MODES", "OVERLAP_MODES",
                  "COMPRESSION_MODES", "QUANTIZE_IMPLS", "WEIGHTING_MODES",
                  "PIPELINE_MODES", "EXPLICIT_REDUCTIONS"):
        assert getattr(tcfgs, const) == getattr(jcfgs, const), const
    assert dataclasses.asdict(tcfgs.TRAIN_4K) == \
        dataclasses.asdict(jcfgs.TRAIN_4K)
    m = tcfgs.MeshConfig((2, 3, 4), ("pod", "data", "model"))
    jm = jcfgs.MeshConfig((2, 3, 4), ("pod", "data", "model"))
    assert (m.num_devices, m.dp_size, m.model_size, m.multi_pod) == \
        (jm.num_devices, jm.dp_size, jm.model_size, jm.multi_pod)


@pytest.mark.parametrize("het", [
    dict(weighting="bogus"), dict(accum_steps=0), dict(bucket_mb=-1.0),
    dict(straggler_ema=1.0), dict(capacities=(1.0, -1.0)),
    dict(overlap="buckets"), dict(overlap="buckets",
                                  grad_reduction="hierarchical"),
    dict(weighting="canonical", accum_steps=2),
    dict(pipeline_stages=2, overlap="buckets",
         grad_reduction="hierarchical", bucket_mb=1.0),
    dict(pipeline_stages=3, accum_steps=2),
    dict(accum_steps=4, capacities=(2.0, 0.0)),
])
def test_het_validate_matches_jax(het):
    """Valid and invalid HetConfigs: the same verdict and message."""
    def verdict(cls):
        try:
            cls(**het).validate()
            return "ok"
        except ValueError as e:
            return str(e)

    assert verdict(tcfgs.HetConfig) == verdict(jcfgs.HetConfig)


@pytest.mark.parametrize("which", ["smoke_config", "resolve"])
def test_olmo_configs_match_jax(which):
    jc = getattr(jcfgs, which)("olmo-1b")
    tc = getattr(tcfgs, which)("olmo-1b")
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert td == jd
    if which == "resolve":
        assert tc.head_dim == 128 and tc.param_count() == jc.param_count()


# --------------------------------------------------------------------------
# (f) the driver
# --------------------------------------------------------------------------


def test_train_cli_flags_match_jax():
    """The JAX driver's flags with the same defaults, plus --device and
    --pipe-axis (the JAX driver's stages never get a pipe axis of their
    own); --data-dir defaults to a temporary directory and --ckpt-dir to one
    under $TMPDIR instead of a fixed path."""
    import argparse
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(main):
        seen.clear()
        try:
            argparse.ArgumentParser.parse_args = lambda self, *a, **k: (
                seen.update({o: act for act in self._actions
                             for o in act.option_strings}),
                sys.exit(0))[1]
            with pytest.raises(SystemExit):
                main()
        finally:
            argparse.ArgumentParser.parse_args = orig
        seen.pop("-h"), seen.pop("--help")
        return dict(seen)

    jf, tf = grab(jtrain.main), grab(ttrain.main)
    assert set(tf) == set(jf) | {"--device", "--pipe-axis"}
    for flag in jf:
        if flag not in ("--data-dir", "--ckpt-dir"):
            assert tf[flag].default == jf[flag].default, flag
    assert tf["--device"].default == "cuda"
    assert tf["--pipe-axis"].default is False
    assert tf["--data-dir"].default == ""
    assert tf["--ckpt-dir"].default == os.path.join(tempfile.gettempdir(),
                                                    "hetseq_ckpt")


def test_cpu_smoke_run_trains_with_dummy_rows():
    out = ttrain.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                       "--steps", "8", "--global-batch", "8", "--seq-len",
                       "16", "--accum", "2", "--lr", "3e-3", "--warmup",
                       "1", "--schedule", "constant", "--log-every", "4"])
    assert out["steps"] == 8 and len(out["losses"]) == 8
    assert all(np.isfinite(out["losses"]))
    assert out["last_loss"] < out["first_loss"]
    assert out["plan"]["buffer_rows"] == 10 and \
        out["plan"]["rows_per_rank"] == [8]            # 2 dummy rows
    assert all(m["weight"] == 8 * 16 for m in out["metrics"])


def test_train_without_cpu_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--smoke", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="model axis"):
        ttrain.main(["--smoke", "--device", "cpu", "--devices", "2,2"])
    for flag in (["--no-scan-layers"],
                 ["--pipeline-stages", "2", "--accum", "2",
                  "--no-scan-layers"],
                 ["--overlap", "buckets", "--grad-reduction",
                  "bucketed_allreduce", "--bucket-mb", "1"],
                 ["--overlap", "backward", "--no-scan-layers",
                  "--grad-reduction", "bucketed_allreduce", "--bucket-mb",
                  "1"],
                 ["--weighting", "canonical"], ["--optimizer", "lamb"]):
        out = ttrain.main(["--smoke", "--device", "cpu", "--steps", "1",
                           "--global-batch", "4", "--seq-len", "8", *flag])
        assert out["steps"] == 1 and np.isfinite(out["losses"][0])
