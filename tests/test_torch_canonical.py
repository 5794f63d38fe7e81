"""repro_torch's order-canonical weighting (``weighting="canonical"``)
and the config rules of the modes ported with it (CPU).

  (a) the config gating: ``HetConfig.validate`` and
      ``validate_train_config`` raise the JAX package's ``ValueError``
      (the same message) for canonical weighting with another
      reduction, overlap, compression or accumulation, for
      ``overlap="backward"`` on a scanned stack or a non-uniform plan,
      and for pipeline stages on either; a valid pipeline config passes
      in both;
  (b) the port's row executor (``steps.canonical_backward``, folding
      each row's gradient into the stream) against JAX's
      ``per_row_values`` + ``canonical_aggregate`` on one device with no
      mesh (olmo-1b smoke at fp32, a dummy row
      included): per-row objective and weight sums 1e-5 relative, the
      aggregate loss 1e-5, every gradient leaf 1e-4 of its largest
      magnitude (``test_torch_train.py``'s tolerances);
  (c) the port's canonical train step on one rank against JAX's
      per-row values, canonical aggregate and AdamW / LAMB update:
      parameters 1e-4 of each leaf's largest magnitude, loss 1e-5, grad
      norm 1e-4;
  (d) bit identity across replans: on two gloo ranks, a run under the
      plans (2,1) x4 and one under (1,1) x2 then (3,1) x2 (the plans of
      ``tests/test_canonical_weighting.py``) over the sampler's
      canonical batches give bitwise-equal losses and parameters, equal
      on both ranks; and the driver trains canonically on two ranks.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.core import weighting as jweighting
from repro.launch import steps as jsteps
from repro.models.model import build_model as jbuild
from repro.optim import adam as jadam
from repro.optim import lamb as jlamb
from repro_torch.configs import base as tcfgs
from repro_torch.core import buckets as tbkt
from repro_torch.core import capacity as tcap
from repro_torch.core import weighting as tweighting
from repro_torch.data import synthetic as tsynth
from repro_torch.data.dataset import ShardedDataset
from repro_torch.data.sampler import HetSampler
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.transformer import tree_leaves

RTOL, GNORM_RTOL, LEAF_TOL = 1e-5, 1e-4, 1e-4


# --------------------------------------------------------------------------
# (a) the config gating
# --------------------------------------------------------------------------

BAD_HET = [
    dict(weighting="canonical", grad_reduction="hierarchical"),
    dict(weighting="canonical", grad_reduction="bucketed_allreduce",
         bucket_mb=4.0),
    dict(weighting="canonical", compression="int8"),
    dict(weighting="canonical", overlap="buckets",
         grad_reduction="bucketed_allreduce", bucket_mb=4.0),
    dict(weighting="canonical", accum_steps=2),
    dict(overlap="buckets"),
    dict(overlap="backward", grad_reduction="hierarchical"),
    dict(overlap="buckets", grad_reduction="bucketed_allreduce"),
    dict(pipeline_stages=2, accum_steps=2, overlap="buckets",
         grad_reduction="bucketed_allreduce", bucket_mb=1.0),
    dict(pipeline_stages=2, accum_steps=2, weighting="canonical"),
]


def _message(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("het", BAD_HET)
def test_het_gating_raises_jax_errors(het):
    want = _message(lambda: jcfgs.HetConfig(**het).validate())
    got = _message(lambda: tcfgs.HetConfig(**het).validate())
    assert want is not None and want[0] == "ValueError"
    assert got == want


# (arch, scan_layers, het, optimizer): build-time rules
BUILD_CASES = [
    ("olmo-1b", True, dict(overlap="backward", bucket_mb=0.05,
                           grad_reduction="bucketed_allreduce"), {}),
    ("xlstm-125m", False, dict(overlap="backward", bucket_mb=0.05,
                               grad_reduction="bucketed_allreduce"), {}),
    ("zamba2-2.7b", False, dict(overlap="backward", bucket_mb=0.05,
                                grad_reduction="bucketed_allreduce"), {}),
    ("olmo-1b", True, dict(pipeline_stages=2, accum_steps=2), {}),
    ("xlstm-125m", False, dict(pipeline_stages=2, accum_steps=2), {}),
    ("olmo-1b", False, dict(pipeline_stages=8, accum_steps=8), {}),
    ("olmo-1b", False, dict(overlap="backward", bucket_mb=0.05,
                            grad_reduction="bucketed_allreduce"),
     dict(name="lamb")),
    ("olmo-1b", True, dict(overlap="buckets", bucket_mb=0.05,
                           grad_reduction="bucketed_allreduce"),
     dict(name="lamb", grad_clip=0.0)),
    ("olmo-1b", True, dict(weighting="canonical"), dict(name="lamb")),
]


@pytest.mark.parametrize("case", BUILD_CASES)
def test_build_gating_raises_jax_errors(case):
    arch, scan, het, opt = case
    jc = dataclasses.replace(jcfgs.smoke_config(arch), scan_layers=scan)
    tc = dataclasses.replace(tcfgs.smoke_config(arch), scan_layers=scan)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    want = _message(lambda: jsteps.validate_train_config(
        jbuild(jc), jcfgs.TrainConfig(
            model=jc, het=jcfgs.HetConfig(**het),
            optimizer=jcfgs.OptimizerConfig(**opt)), jmesh))
    got = _message(lambda: tsteps.validate_train_config(
        tbuild(tc, "cpu"), tcfgs.TrainConfig(
            model=tc, het=tcfgs.HetConfig(**het),
            optimizer=tcfgs.OptimizerConfig(**opt)),
        mesh_mod.local((1, 1), ("data", "model"))))
    assert got == want


# --------------------------------------------------------------------------
# (b), (c) against JAX on one device
# --------------------------------------------------------------------------


def _pair(seed=0):
    jc = dataclasses.replace(jcfgs.smoke_config("olmo-1b"),
                             compute_dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config("olmo-1b"),
                             compute_dtype="float32")
    jm = jbuild(jc)
    params = jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(seed)))
    return jm, tbuild(tc, "cpu"), params


def _batch(rows=5, seq=8, seed=3):
    rng = np.random.default_rng(seed)
    w = (rng.random((rows, seq)) > 0.1).astype(np.float32)
    w[-1] = 0.0                                 # a dummy row
    return {"inputs": rng.integers(0, 256, (rows, seq)).astype(np.int32),
            "labels": rng.integers(0, 256, (rows, seq)).astype(np.int32),
            "weights": w}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close(port_tree, jax_tree, what):
    got = _flat(params_to_numpy(port_tree))
    want = _flat(jax.tree.map(np.asarray, jax_tree))
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=0,
            atol=LEAF_TOL * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{what} {k}")


def test_per_row_values_and_canonical_aggregate_match_jax():
    """The port's executor (``steps.canonical_backward``, the row loop
    the canonical step runs, here over every row on one rank) against
    JAX's ``per_row_values`` + ``canonical_aggregate``."""
    jm, tm, params = _pair()
    b = _batch()
    (jo, jw), jg = jweighting.per_row_values(
        lambda p, x: jm.loss_fn(p, x), jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in b.items()})
    jloss, jgrads, _, jwsum = jweighting.canonical_aggregate(jo, jw, jg)
    tparams = params_from_jax(params, tm.cfg, "cpu")
    tcfg = tcfgs.TrainConfig(model=tm.cfg,
                             het=tcfgs.HetConfig(weighting="canonical"))
    layout = tbkt.build_layout(tparams, bucket_mb=0.02)
    stream = torch.zeros((layout.num_buckets, layout.bucket_elems))
    rows = range(b["inputs"].shape[0])
    to, tw = tsteps.canonical_backward(
        tm, tcfg, tparams, {k: torch.from_numpy(v) for k, v in b.items()},
        rows, stream, layout)
    to, tw = torch.stack(to), torch.stack(tw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert float(tw[-1]) == 0.0                 # the dummy row ran
    twsum = tweighting.fold(list(tw))
    tloss = tweighting.finalize(tweighting.fold(list(to)), twsum)
    tgrads = tweighting.scale_grads(
        tbkt.unpack_buckets(stream, layout, tparams), twsum)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    assert float(twsum) == float(jwsum)
    _close(tgrads, jgrads, "canonical gradient")


@pytest.mark.parametrize("opt", ["adamw", "lamb"])
def test_canonical_step_matches_jax(opt):
    jm, tm, params = _pair()
    b = _batch(rows=4)
    ocfg = dict(name=opt, lr=1e-3, warmup_steps=1, schedule="constant")
    jo = jcfgs.OptimizerConfig(**ocfg)
    jp = jax.tree.map(jnp.asarray, params)
    (o, w), g = jweighting.per_row_values(
        lambda p, x: jm.loss_fn(p, x), jp,
        {k: jnp.asarray(v) for k, v in b.items()})
    jloss, jgrads, _, _ = jweighting.canonical_aggregate(o, w, g)
    jstate = jadam.init_state(jp, jo)
    apply = jlamb.apply_update if opt == "lamb" else jadam.apply_update
    jp2, _, jmet = apply(jp, jgrads, jstate, jo,
                         jnp.asarray(1e-3, jnp.float32))
    tcfg = tcfgs.TrainConfig(model=tm.cfg,
                             het=tcfgs.HetConfig(weighting="canonical"),
                             optimizer=tcfgs.OptimizerConfig(**ocfg))
    tparams = params_from_jax(params, tm.cfg, "cpu")
    state = tsteps.TrainState(
        params=tparams, opt=tsteps.init_train_state(tm, tcfg).opt, err=())
    state, met = tsteps.build_train_step(tm, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=GNORM_RTOL)
    assert ("trust_ratio" in met) == (opt == "lamb")
    _close(state.params, jp2, "params after one canonical step")


# --------------------------------------------------------------------------
# (d) bit identity across replans
# --------------------------------------------------------------------------

PLANS = {"fixed": ((2.0, 1.0),) * 4,
         "replanned": ((1.0, 1.0),) * 2 + ((3.0, 1.0),) * 2}
SEQ = 16
ROWS = 6


def canonical_rank(rank, world, init_method, corpus):
    mesh_mod.share_cpu(world)
    mesh = mesh_mod.init((world, 1), ("data", "model"), rank, init_method,
                         "cpu")
    out = {}
    try:
        mc = dataclasses.replace(tcfgs.smoke_config("olmo-1b"),
                                 compute_dtype="float32",
                                 attention_impl="kernel")
        model = tbuild(mc, "cpu")
        tcfg = tcfgs.TrainConfig(
            model=mc, shape=tcfgs.ShapeConfig("t", SEQ, ROWS, "train"),
            het=tcfgs.HetConfig(weighting="canonical").validate(),
            optimizer=tcfgs.OptimizerConfig(lr=1e-3, warmup_steps=2))
        ds = ShardedDataset(corpus)
        for name, caps in PLANS.items():
            plans = [tcap.plan_capacities(ROWS, c) for c in caps]
            smp = HetSampler(ds, plans[0], seed=3, canonical_order=True)
            state = tsteps.init_train_state(model, tcfg, mesh=mesh)
            step = tsteps.build_train_step(model, tcfg, mesh)
            losses, rows = [], []
            for plan, entry in zip(plans, smp.epoch_batches(0)):
                smp.set_plan(plan)
                raw = smp.pack(entry)
                rows.append(plan.rows_per_rank.tolist())
                state, met = step(state, {k: torch.from_numpy(
                    np.ascontiguousarray(raw[k][:, :SEQ]))
                    for k in ("inputs", "labels", "weights")})
                losses.append(float(met["loss"]))
            out[name] = {"losses": losses, "rows": rows,
                         "checksum": tsteps.params_checksum(state.params),
                         "params": [t.numpy().copy()
                                    for t in tree_leaves(state.params)]}
    finally:
        mesh_mod.destroy(mesh)
    return out


def test_canonical_bit_identity_across_replans():
    with tempfile.TemporaryDirectory() as root:
        corpus = tsynth.build_synthetic_corpus(
            root + "/c", num_seqs=20, seq_len=SEQ + 1, vocab=256,
            rows_per_shard=8, seed=0)
        ranks = mesh_mod.spawn(canonical_rank, 2, (corpus,), timeout_s=300)
    for r in ranks:
        fixed, replanned = r["fixed"], r["replanned"]
        assert fixed["rows"] != replanned["rows"]       # the plans differ
        assert fixed["losses"] == replanned["losses"]
        assert all(np.isfinite(fixed["losses"]))
        for a, b in zip(fixed["params"], replanned["params"]):
            np.testing.assert_array_equal(a, b)
    assert len({r[k]["checksum"] for r in ranks for k in PLANS}) == 1
    # the rows each rank runs depend on the row and rank counts only
    assert [list(tsteps.canonical_rows(ROWS, 2, r)) for r in (0, 1)] == \
        [[0, 1, 2], [3, 4, 5]]


def test_cpu_driver_trains_canonically_on_two_ranks():
    out = ttrain.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                       "--devices", "2,1", "--weighting", "canonical",
                       "--capacities", "2,1", "--steps", "3",
                       "--global-batch", "6", "--seq-len", "16",
                       "--lr", "3e-3", "--warmup", "1", "--schedule",
                       "constant"])
    assert out["steps"] == 3 and all(np.isfinite(out["losses"]))
    assert len(set(out["end_checksums"])) == 1
    assert all(m["weight"] == 6 * 16 for m in out["metrics"])
