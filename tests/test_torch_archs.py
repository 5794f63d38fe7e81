"""The last five archs of the JAX package in repro_torch (glm4-9b,
phi4-mini-3.8b, arctic-480b, chameleon-34b, musicgen-large) and the
features they bring: QK-norm (chameleon), GELU and LayerNorm biases
(musicgen), Arctic's dense residual MLP beside its experts, the
embedding-stub frontend (chameleon, musicgen: (B, S, d) inputs, no
table, an untied head) and head dim 128 on the paged engine (glm4, phi4,
arctic).

  (a) ``count_params_analytic`` equals the JAX tree's size for every
      arch, smoke and full (shapes only on the JAX side);
  (b) each new arch's smoke config at fp32, JAX ``init_params`` carried
      over by ``params_from_jax``: ``logits_fn``, the contiguous prefill
      (logits and cache) and three decode steps against the JAX model
      (stub embeddings for chameleon and musicgen; QK-norm runs at
      decode too); the tree converts back leaf for leaf;
  (c) chameleon and musicgen: ``loss_fn`` and its gradient against
      ``jax.value_and_grad`` of JAX's; two ``build_train_step`` steps
      against JAX's on a (1, 1) mesh of Auto axes with AdamW and LAMB,
      every parameter and moment leaf (the decay of q_norm/k_norm and of
      the LayerNorm biases, matrices in JAX's stacked layout, included);
      ``overlap="backward"`` and ``"buckets"`` bitwise ``"none"`` (the
      JAX package's own invariant for a stub model), the pipelined step
      bitwise the one-stage step, the canonical step against the
      monolithic one; the checkpoint template (``state_shapes``), the
      ``checkpoint_format`` block and the bucket readiness equal JAX's
      for a tree with no ``embed``;
  (d) glm4, phi4 and arctic smoke: the port's paged engine gives the JAX
      engine's tokens and scheduling stats (arctic one sequence at a
      time: its MoE prefill capacity follows the batch's tokens);
  (e) GELU: the port's tanh form is ``jax.nn.gelu``'s, the erf form
      misses it;
  (f) refusals: the serve driver (JAX's message) and the paged decode
      refuse a stub arch, the train driver refuses one with a
      ``ValueError`` (its corpus is token ids); arctic's MoE trains
      (``loss_fn``, aux loss in the metrics) while the recurrent plans'
      training still raises.

Tolerances (fp32, the same arithmetic in another order): logits,
caches and losses 2e-5 absolute or 1e-5 relative; gradients,
parameters and moments 1e-4 of each leaf's largest magnitude (the
train tests' limits); GELU 1e-6.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from jax.sharding import AbstractMesh

from repro import compat
from repro.checkpoint import repack as jrepack
from repro.configs import base as jcfgs
from repro.core import buckets as jbkt
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models.blocks import LOCAL_CTX
from repro.models.kvcache import PagedLayout as JLayout
from repro.models.model import build_model as jbuild
from repro_torch.checkpoint import repack as trepack
from repro_torch.configs import base as tcfgs
from repro_torch.core import buckets as tbkt
from repro_torch.core import capacity as tcap
from repro_torch.core import dummy as tdummy
from repro_torch.core.accumulate import value_and_grad
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tblocks
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.kvcache import PagedLayout as TLayout
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim import adam as tadam

TOKEN = ["glm4-9b", "phi4-mini-3.8b", "arctic-480b"]
STUB = ["chameleon-34b", "musicgen-large"]
NEW = TOKEN + STUB
ALL = ["arctic-480b", "chameleon-34b", "deepseek-v2-236b", "glm4-9b",
       "musicgen-large", "olmo-1b", "phi4-mini-3.8b", "tinyllama-1.1b",
       "xlstm-125m", "zamba2-2.7b"]
TOL = 2e-5
RTOL = 1e-5
GNORM_RTOL = 1e-4
LEAF_TOL = 1e-4


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jcfgs.smoke_config(arch),
                             compute_dtype="float32", **kw)
    tc = dataclasses.replace(tcfgs.smoke_config(arch),
                             compute_dtype="float32", **kw)
    return jc, tc


def _jax_params(jmodel, seed=0):
    return jax.tree.map(np.asarray, jax.jit(jmodel.init_params)(
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


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def _inputs(cfg, rng, shape):
    """Token ids, or stub embeddings (..., d) for a stub frontend."""
    if cfg.frontend == "token":
        return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


# --------------------------------------------------------------------------
# (a) parameter counts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ALL)
def test_count_params_analytic_equals_the_jax_tree(arch):
    from repro.models.model import count_params_analytic as jcount
    for get in ("smoke_config", "resolve"):
        jc, tc = getattr(jcfgs, get)(arch), getattr(tcfgs, get)(arch)
        shapes = jax.eval_shape(jbuild(jc).init_params,
                                jax.random.PRNGKey(0))
        n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
        assert tc.param_count() == n == jcount(jc), (arch, get)
    smoke = tbuild(tcfgs.smoke_config(arch), "cpu").init_params(0)
    assert sum(int(t.numel()) for t in tree_leaves(smoke)) == \
        tcfgs.smoke_config(arch).param_count()


# --------------------------------------------------------------------------
# (b) forward, prefill and decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["reference", "kernel"])
@pytest.mark.parametrize("arch", NEW)
def test_forward_prefill_and_decode_match_jax(arch, impl):
    jc, tc = _cfgs(arch)
    tc = dataclasses.replace(tc, attention_impl=impl)
    jmodel, tmodel = jbuild(jc), tbuild(tc, "cpu")
    jparams = _jax_params(jmodel)
    params = params_from_jax(jparams, tc, "cpu")
    back = _flat(params_to_numpy(params))
    want_tree = _flat(jparams)
    assert set(back) == set(want_tree)
    for k in want_tree:
        np.testing.assert_array_equal(back[k], want_tree[k])
    assert ("embed" in params) == (tc.frontend == "token")
    if arch == "chameleon-34b":
        assert params["layers"][0]["attn"]["q_norm"].shape == (tc.head_dim,)
    if arch == "musicgen-large":
        assert set(params["layers"][0]["mlp"]) == {"w_up", "w_down"}
        assert set(params["layers"][0]["ln1"]) == {"scale", "bias"}
    if arch == "arctic-480b":
        assert set(params["layers"][0]) >= {"moe", "dense"}

    rng = np.random.default_rng(7)
    x = _inputs(tc, rng, (2, 14))
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    # (a MoE forward outside serving runs the training capacity, as
    # JAX's logits_fn does)
    with torch.no_grad():
        _close(tmodel.logits_fn(params, tx),
               jmodel.logits_fn(jparams, jx))
    jl, jcache = jmodel.prefill(jparams, jx[:, :11], max_len=14)
    tl, tcache = tmodel.prefill(params, tx[:, :11], max_len=14)
    for pos in (11, 12, 13):
        _close(tl, jl)
        for name in ("k", "v"):
            _close(tcache[name], jcache[name])
        jl, jcache = jmodel.decode(jparams, jx[:, pos], jcache,
                                   jnp.int32(pos))
        tl, tcache = tmodel.decode(params, tx[:, pos], tcache, pos)
    _close(tl, jl)


# --------------------------------------------------------------------------
# (c) stub-frontend training
# --------------------------------------------------------------------------


def _stub_batch(cfg, rng, rows, seq, dummy_rows=1):
    w = (rng.random((rows, seq)) > 0.1).astype(np.float32)
    w[rows - dummy_rows:] = 0.0
    return {"inputs": _inputs(cfg, rng, (rows, seq)),
            "labels": rng.integers(0, cfg.vocab_size, (rows, seq)).astype(
                np.int32),
            "weights": w}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("impl,remat", [("kernel", "none"),
                                        ("kernel", "full"),
                                        ("reference", "none")])
@pytest.mark.parametrize("arch", STUB)
def test_stub_loss_and_grads_match_jax(arch, impl, remat):
    jc, tc = _cfgs(arch)
    tc = dataclasses.replace(tc, attention_impl=impl, remat=remat)
    jmodel = jbuild(jc)
    jparams = _jax_params(jmodel)
    batch = _stub_batch(tc, np.random.default_rng(1), 3, 12)

    def jobj(p, b):
        o, w, _ = jmodel.loss_fn(p, b, LOCAL_CTX, label_smoothing=0.1)
        return o, w

    (jo, jw), jg = jax.value_and_grad(jobj, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = tbuild(tc, "cpu")
    params = params_from_jax(jparams, tc, "cpu")
    (to, tw), tg = value_and_grad(tmodel.loss_fn, params, _tb(batch),
                                  ce_impl=impl, label_smoothing=0.1)
    np.testing.assert_allclose(float(to), float(jo), rtol=RTOL)
    assert float(tw) == float(jw) == float(batch["weights"].sum())
    _assert_trees_close(tg, jg, f"{arch} grads")


def _train_cfgs(arch, opt_name, accum=2):
    jc, tc = _cfgs(arch)
    tc = dataclasses.replace(tc, attention_impl="kernel")
    shape = ("t", 12, 4, "train")
    opt = dict(name=opt_name, lr=1e-3, warmup_steps=1, schedule="constant",
               total_steps=2)
    tj = jcfgs.TrainConfig(
        model=jc, shape=jcfgs.ShapeConfig(*shape),
        het=jcfgs.HetConfig(accum_steps=accum),
        optimizer=jcfgs.OptimizerConfig(**opt), label_smoothing=0.1)
    tt = tcfgs.TrainConfig(
        model=tc, shape=tcfgs.ShapeConfig(*shape),
        het=tcfgs.HetConfig(accum_steps=accum),
        optimizer=tcfgs.OptimizerConfig(**opt), label_smoothing=0.1)
    return jc, tc, tj, tt


def _stub_batches(cfg, accum, steps=2, seed=5):
    """Packed batches of 4 real rows of 12 (the plan's dummy rows carry
    weight 0): stub embeddings and labels from a numpy seed."""
    plan = tcap.plan_capacities(4, (1.0,), headroom=1.25,
                                round_buffer_to=accum)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        b = _stub_batch(cfg, rng, plan.buffer_rows, 12,
                        dummy_rows=plan.buffer_rows - 4)
        out.append(b)
    assert all((b["weights"] == 0).all(axis=1).any() for b in out)
    return out


@pytest.mark.parametrize("opt_name", ["adamw", "lamb"])
@pytest.mark.parametrize("arch", STUB)
def test_two_stub_train_steps_match_jax(arch, opt_name):
    jc, tc, tj, tt = _train_cfgs(arch, opt_name)
    batches = _stub_batches(tc, 2)
    mesh = _auto_mesh()
    jmodel = jbuild(jc)
    jmet = []
    with compat.set_mesh(mesh):
        jstep = jsteps.build_train_step(jmodel, tj, mesh)
        jstate = jsteps.init_train_state(jmodel, tj, mesh,
                                         jax.random.PRNGKey(0))
        params0 = jax.tree.map(np.asarray, jstate.params)
        for b in batches:
            jstate, met = jstep(jstate, {k: jnp.asarray(v)
                                         for k, v in b.items()})
            jmet.append({k: float(v) for k, v in met.items()})
    model = tbuild(tc, "cpu")
    params = params_from_jax(params0, tc, "cpu")
    state = tsteps.TrainState(params=params, opt=tadam.init_state(
        params, tt.optimizer), err=())
    step = tsteps.build_train_step(model, tt)
    for b, want in zip(batches, jmet):
        state, met = step(state, _tb(b))
        np.testing.assert_allclose(float(met["loss"]), want["loss"],
                                   rtol=RTOL)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   want["grad_norm"], rtol=GNORM_RTOL)
        if opt_name == "lamb":
            np.testing.assert_allclose(float(met["trust_ratio"]),
                                       want["trust_ratio"], rtol=GNORM_RTOL)
    _assert_trees_close(state.params, jstate.params, f"{arch} params")
    _assert_trees_close(state.opt.m, jstate.opt.m, f"{arch} m")
    _assert_trees_close(state.opt.v, jstate.opt.v, f"{arch} v")
    # the per-layer vectors (QK-norm scales, LayerNorm scales and biases)
    # are matrices in JAX's stacked layout: they decay, as there
    decays = {len(shape) >= 2 for shape, (ps,) in tadam.leaf_groups(
        {"layers": state.params["layers"]})}
    assert decays == {True}
    moved = _flat(params_to_numpy(state.params))
    start = _flat(params0)
    vectors = [k for k in moved if k.startswith("layers/")
               and moved[k].ndim == 2 and moved[k].shape[1] in
               (tc.head_dim, tc.d_model) and ("norm" in k or "ln" in k)]
    assert vectors and all(not np.array_equal(moved[k], start[k])
                           for k in vectors)


def _steps_run(tc, tcfg, batches):
    model = tbuild(tc, "cpu")
    mesh = mesh_mod.local(device="cpu")
    state = tsteps.init_train_state(model, tcfg, mesh=mesh)
    step = tsteps.build_train_step(model, tcfg, mesh)
    losses = []
    for b in batches:
        state, met = step(state, _tb(b))
        losses.append(float(met["loss"]))
    return losses, _flat(params_to_numpy(state.params))


def _het_tcfg(tc, **het):
    return tcfgs.TrainConfig(
        model=tc, shape=tcfgs.ShapeConfig("t", 12, 4, "train"),
        het=tcfgs.HetConfig(**het),
        optimizer=tcfgs.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                        grad_clip=0.0),
        label_smoothing=0.1)


@pytest.mark.parametrize("arch", STUB)
def test_stub_step_builders_agree(arch):
    """Every step builder takes a stub batch: ``overlap="backward"`` and
    ``"buckets"`` bitwise ``"none"`` (bucketed_allreduce, fp32, clip 0),
    two pipeline stages bitwise one (1F1B and GPipe), the canonical step
    (one row at a time: other sums) within 1e-5 of the monolithic step's
    losses and 1e-4 relative L2 of its parameters, leaf by leaf (Adam
    turns a last-bit difference of a near-zero gradient into a visible
    step of that one element, so elements are not compared)."""
    _, tc = _cfgs(arch, scan_layers=False)
    tc = dataclasses.replace(tc, attention_impl="kernel")
    batches = _stub_batches(tc, 2)
    base = dict(grad_reduction="bucketed_allreduce", bucket_mb=0.05,
                accum_steps=2)
    want = _steps_run(tc, _het_tcfg(tc, **base), batches)
    for overlap in ("backward", "buckets"):
        got = _steps_run(tc, _het_tcfg(tc, **base, overlap=overlap),
                         batches)
        assert got[0] == want[0], overlap
        assert all(np.array_equal(got[1][k], want[1][k]) for k in want[1])
    for sched in ("1f1b", "gpipe"):
        got = _steps_run(tc, _het_tcfg(tc, **base, pipeline_stages=2,
                                       pipeline_schedule=sched), batches)
        assert got[0] == want[0], sched
        assert all(np.array_equal(got[1][k], want[1][k]) for k in want[1])
    flat = _steps_run(tc, _het_tcfg(tc, accum_steps=2), batches)
    canon = _steps_run(tc, _het_tcfg(tc, weighting="canonical"), batches)
    np.testing.assert_allclose(canon[0], flat[0], rtol=RTOL)
    for k, w in flat[1].items():
        rel = np.linalg.norm(canon[1][k] - w) / np.linalg.norm(w)
        assert rel <= LEAF_TOL, (k, rel)


@pytest.mark.parametrize("overlap", ["none", "buckets"])
@pytest.mark.parametrize("arch", NEW)
def test_checkpoint_template_and_readiness_match_jax(arch, overlap):
    het = dict(grad_reduction="hierarchical", compression="int8",
               bucket_mb=0.05, overlap=overlap)
    jc = dataclasses.replace(jcfgs.smoke_config(arch), scan_layers=False)
    tc = dataclasses.replace(tcfgs.smoke_config(arch), scan_layers=False)
    jtc = jcfgs.TrainConfig(model=jc, het=jcfgs.HetConfig(**het))
    ttc = tcfgs.TrainConfig(model=tc, het=tcfgs.HetConfig(**het))
    axes = ("pod", "data", "model")
    jmodel, tmodel = jbuild(jc), tbuild(tc, "cpu")
    jmesh = AbstractMesh((2, 1, 1), axes)
    tmesh = mesh_mod.unjoined((2, 1, 1), axes)

    def specs(tree):
        return [(k, tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in tree.items()]

    assert specs(trepack.flatten_with_paths(tsteps.state_shapes(
        tmodel, ttc, tmesh))) == specs(jrepack.flatten_with_paths(
            jsteps.state_shapes(jmodel, jtc, jmesh)))
    assert tsteps.checkpoint_format(tmodel, ttc, tmesh) == \
        jsteps.checkpoint_format(jmodel, jtc, jmesh)
    jshape = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    tparams = tmodel.init_params(0)
    jpieces = jsteps._staged_leaf_pieces(jshape, jc)
    tpieces = tsteps.staged_leaf_pieces(tparams, tc)
    assert tpieces == [list(p) for p in jpieces]
    jlo = jbkt.build_layout(jshape, bucket_mb=0.02, multiple_of=512)
    tlo = tbkt.build_layout(tparams, bucket_mb=0.02, multiple_of=512)
    assert tbkt.bucket_readiness(tlo, tpieces) == \
        jbkt.bucket_readiness(jlo, jpieces)


# --------------------------------------------------------------------------
# (d) the paged engine at head dim 128's archs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", TOKEN)
def test_engine_tokens_and_stats_match_jax_engine(arch):
    jc, tc = _cfgs(arch)
    tc = dataclasses.replace(tc, attention_impl="kernel")
    jmodel = jbuild(jc)
    mesh = _auto_mesh()
    jparams = jsteps.init_params_sharded(jmodel, mesh, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tc, "cpu")
    tmodel = tbuild(tc, "cpu")
    one = arch == "arctic-480b"
    slots, pb = (1, 1) if one else (4, 2)
    kw = dict(n=6 if one else 10, vocab=jc.vocab_size, rate=0.5,
              prompt_lens=(4, 24), gen_lens=(2, 12), seed=3)
    geo = dict(block_size=4, num_blocks=9 if one else 18,
               max_blocks_per_seq=9)
    with compat.set_mesh(mesh):
        jeng = jserve.build_engine(jmodel, jparams, mesh, JLayout(**geo),
                                   slots=slots, prefill_batch=pb,
                                   pod_speeds=[1.0] if one else [1.0, 0.5])
        jres = jeng.run(jserve.synthetic_requests(**kw))
    teng = tserve.build_engine(tmodel, params, TLayout(**geo), slots=slots,
                               prefill_batch=pb,
                               pod_speeds=[1.0] if one else [1.0, 0.5])
    reqs = tserve.synthetic_requests(**kw)
    tres = teng.run(reqs)
    assert tres.tokens == jres.tokens
    for key in ("decode_steps", "prefill_groups", "preemptions",
                "pod_limits", "total_tokens", "peak_active_per_pod"):
        assert tres.stats[key] == jres.stats[key], key
    for r in reqs:
        assert len(tres.tokens[r.rid]) == r.max_new_tokens


@pytest.mark.parametrize("arch", TOKEN)
def test_cli_serves_the_smoke_config_on_cpu(arch):
    res = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2"])
    assert res.stats["requests"] == 3 and res.stats["total_tokens"] > 0


# --------------------------------------------------------------------------
# (e) GELU
# --------------------------------------------------------------------------


def test_gelu_is_jax_tanh_form_and_not_erf():
    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tblocks.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4
    # the musicgen MLP (gate-less) against JAX's on the same weights
    from repro.models import blocks as jblocks
    jc, tc = _cfgs("musicgen-large")
    p = _jax_params(jbuild(jc))["layers"]["mlp"]
    h = np.random.default_rng(2).standard_normal((2, 5, tc.d_model)).astype(
        np.float32)
    jy = jblocks.mlp_block({k: jnp.asarray(v[0]) for k, v in p.items()},
                           jnp.asarray(h), jc, LOCAL_CTX)
    ty = tblocks.mlp_block({k: torch.from_numpy(v[0]) for k, v in p.items()},
                           torch.from_numpy(h), tc)
    _close(ty, jy)
    up = torch.from_numpy(h) @ torch.from_numpy(p["w_up"][0])
    y_erf = torch.nn.functional.gelu(up) @ torch.from_numpy(p["w_down"][0])
    assert np.abs(y_erf.numpy() - np.asarray(jy)).max() > 10 * TOL


# --------------------------------------------------------------------------
# (f) refusals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", STUB)
def test_drivers_refuse_stub_archs(arch):
    with pytest.raises(SystemExit) as jerr:
        jserve.serve(argparse.Namespace(arch=arch, smoke=True))
    with pytest.raises(SystemExit) as terr:
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert str(terr.value) == str(jerr.value)
    assert "token frontend" in str(terr.value)
    with pytest.raises(ValueError, match="token ids"):
        ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--steps", "1", "--global-batch", "2", "--seq-len",
                     "8"])
    jc, tc = _cfgs(arch)
    jmodel, tmodel = jbuild(jc), tbuild(tc, "cpu")
    layout = dict(block_size=4, num_blocks=4, max_blocks_per_seq=2)
    with pytest.raises(ValueError) as jerr2:
        jmodel.decode_paged(_jax_params(jmodel),
                            jnp.zeros((1, tc.d_model)),
                            jmodel.init_paged_cache(JLayout(**layout)),
                            jnp.zeros((1, 2), jnp.int32),
                            jnp.ones((1,), jnp.int32))
    params = tmodel.init_params(0)
    with pytest.raises(ValueError) as terr2:
        tmodel.decode_paged(params, torch.zeros((1, tc.d_model)),
                            tmodel.init_paged_cache(TLayout(**layout)),
                            torch.zeros((1, 2), dtype=torch.int32),
                            torch.ones((1,), dtype=torch.int32))
    assert str(terr2.value) == str(jerr2.value)


def test_moe_training_still_raises():
    """MoE training is ported (tests/test_torch_moe_train.py): arctic's
    ``loss_fn`` trains, its aux loss in the metrics, and so does
    xLSTM's (tests/test_torch_xlstm_train.py; the Mamba2 plans:
    tests/test_torch_zamba_train.py); a hybrid without an SSM is what
    still raises."""
    _, tc = _cfgs("arctic-480b")
    model = tbuild(tc, "cpu")
    params = model.init_params(0)
    batch = _tb(_stub_batch(tc, np.random.default_rng(0), 2, 8))
    obj, w, met = model.loss_fn(params, batch)
    assert torch.isfinite(obj) and float(w) == float(batch["weights"].sum())
    assert float(met["aux"]) > 0
    model = tbuild(tcfgs.smoke_config("xlstm-125m"), "cpu")
    obj, w, _ = model.loss_fn(model.init_params(0), {
        "inputs": torch.zeros((1, 4), dtype=torch.int32),
        "labels": torch.zeros((1, 4), dtype=torch.int32),
        "weights": torch.ones((1, 4))})
    assert torch.isfinite(obj) and float(w) == 4.0
    zamba = tcfgs.smoke_config("zamba2-2.7b")
    with pytest.raises(ValueError, match="hybrid without an SSM"):
        tbuild(dataclasses.replace(zamba, ssm=dataclasses.replace(
            zamba.ssm, state_dim=0)), "cpu")
