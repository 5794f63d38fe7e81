"""MoE and MLA training in repro_torch against the JAX package (CPU, fp32,
smoke configs, numpy-seeded inputs, JAX's parameters carried over).

  (a) ``moe_block(train=True)`` (the training capacity, lowered until
      tokens drop): output, aux loss and the gradients of the parameters
      and the input under one cotangent against ``jax.vjp`` of JAX's;
  (b) deepseek-v2 (MLA + MoE with shared experts) and arctic-480b (MoE
      with the dense residual MLP): ``loss_fn`` and every leaf's
      gradient against ``jax.value_and_grad``; ``logits_fn`` (the
      training capacity, as JAX's); two AdamW train steps against JAX's
      ``build_train_step`` on a (1, 1) mesh of Auto axes; the canonical
      step's loss against JAX's one-row ``loss_fn`` objectives (each row
      routed alone, as JAX's ``per_row_values`` routes it);
  (c) the aux term across two gloo ranks at capacities 2,1 (unequal
      real rows, so the two rules below differ): one step of the port
      under "allreduce", "hierarchical" (one pod of two data ranks),
      "bucketed_allreduce" and "hierarchical" with int8 across two pods
      of one rank (to ``test_torch_dist_train.py``'s int8 limits), accum
      2, against the JAX objective of that
      mode built from JAX's one-device ``loss_fn``: ``sum ce + mean_r
      (aux_r) * W`` with ``W`` the microbatch's weight over both ranks
      (the routing region of JAX's SPMD step spans the data ranks), or
      ``sum_r (ce_r + aux_r * W_r)`` for "bucketed_allreduce" (each rank
      its own region). The reference is built from the one-device
      function because JAX's own "bucketed_allreduce" step on a MoE
      stack (``vmapped_rank_grads`` around ``moe_block``'s
      ``shard_map``) does not follow its formula on jax 0.9.0 with
      forced host devices: with equal weights, where every rule agrees,
      its grad norm reads 8.556 against 9.987 from its own "allreduce"
      and "hierarchical" steps and from the formula (ROADMAP.md §3).
      Parameters to ``test_torch_pipeline.py``'s rule: 1e-4 of a leaf's
      largest magnitude but for at most one element in 10,000 of a leaf
      (at least one), within 1e-3: after an AdamW step at eps 1e-9 an
      element whose gradient sits at its sum's rounding noise takes a
      sign-like step that last-bit differences move;
      The same spawn runs two pipeline stages on their own ranks (a
      ``pipe`` axis), bitwise the one-process pipelined step;
  (d) ``overlap="backward"`` and ``"buckets"`` and the pipelined step
      (1F1B and GPipe) bitwise the monolithic step on the deepseek
      smoke model (fp32, clip 0); the train driver trains both archs'
      smoke configs on the CPU;
  (e) ``configs.base.optimizer_for`` field for field JAX's for every
      arch; the AdamW update in row blocks bitwise the whole-leaf one.

Tolerances (fp32, the same arithmetic in another order): outputs,
logits and losses 2e-5 absolute or 1e-5 relative; gradients,
parameters and moments 1e-4 of each leaf's largest magnitude; grad
norms 1e-4 relative.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tcfgs
from repro_torch.core import capacity as tcap
from repro_torch.core import dummy as tdummy
from repro_torch.core.accumulate import value_and_grad
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as tsteps
from repro_torch.models import blocks as tblocks
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import build_model as tbuild
from repro_torch.optim import adam as tadam

MOE = ["deepseek-v2-236b", "arctic-480b"]
TOL = 2e-5
RTOL = 1e-5
GNORM_RTOL = 1e-4
LEAF_TOL = 1e-4
OUTLIER_TOL = 1e-3          # the few elements past LEAF_TOL, (c) below
SEQ = 12
OPT = dict(lr=1e-3, warmup_steps=1, schedule="constant", total_steps=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size steps run fastest on one intra-op thread, and the suite
    runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, moe=None, **kw):
    from repro.configs import base as jcfgs
    jc = dataclasses.replace(jcfgs.smoke_config(arch),
                             compute_dtype="float32", **kw)
    tc = dataclasses.replace(tcfgs.smoke_config(arch),
                             compute_dtype="float32", **kw)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


def _jax_params(jmodel, seed=0):
    import jax
    return jax.tree.map(np.asarray, jax.jit(jmodel.init_params)(
        jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """(JAX config, model, its parameters at seed 0), once per arch."""
    from repro.models.model import build_model as jbuild
    jc, _ = _cfgs(arch)
    jmodel = jbuild(jc)
    return jc, jmodel, _jax_params(jmodel)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    """JAX's ``loss_fn`` (label smoothing 0.1), its aux and gradient on
    ``_batch(seed 1, 3 rows)``, jitted, once per arch."""
    import jax
    from repro.models.blocks import LOCAL_CTX
    jc, jmodel, jparams = _jax_model(arch)
    batch = _batch(jc, np.random.default_rng(1), 3)

    def jobj(p, b):
        o, w, met = jmodel.loss_fn(p, b, LOCAL_CTX, label_smoothing=0.1)
        return o, (w, met["aux"])

    (jo, (jw, jaux)), jg = jax.jit(jax.value_and_grad(jobj, has_aux=True))(
        jparams, _jb(batch))
    return batch, float(jo), float(jw), float(jaux), jg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_close(port_tree, jax_tree, what, tol=LEAF_TOL):
    import jax
    got = _flat(params_to_numpy(port_tree))
    want = _flat(jax.tree.map(np.asarray, jax_tree))
    assert set(got) == set(want), what
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (what, path)
        atol = tol * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=f"{what} {path}")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def _batch(cfg, rng, rows, seq=SEQ, dummy_rows=1):
    w = (rng.random((rows, seq)) > 0.1).astype(np.float32)
    w[rows - dummy_rows:] = 0.0
    return {"inputs": rng.integers(0, cfg.vocab_size, (rows, seq)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (rows, seq)).astype(
                np.int32),
            "weights": w}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _jb(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# (a) the block
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shared", [1, 0])
def test_moe_block_train_output_aux_and_grads_match_jax(shared):
    import jax
    import jax.numpy as jnp
    from repro.models import blocks as jblocks
    jc, tc = _cfgs("deepseek-v2-236b", moe=dict(capacity_factor=0.5,
                                                num_shared_experts=shared))
    jp = jax.tree.map(np.asarray, jblocks.init_moe(jc,
                                                   jax.random.PRNGKey(3)))
    rng = np.random.default_rng(shared)
    x = rng.standard_normal((2, 16, jc.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    aux_cot = 3.5

    def jfn(p, xx, c):
        out, vjp = jax.vjp(lambda q, z: jblocks.moe_block(
            q, z, jc, jblocks.LOCAL_CTX), p, xx)
        return out, vjp((c, jnp.float32(aux_cot)))

    (jy, jaux), (jgp, jgx) = jax.jit(jfn)(jax.tree.map(jnp.asarray, jp),
                                          jnp.asarray(x), jnp.asarray(cot))

    def to_torch(t):
        return {k: to_torch(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)) for k, v in t.items()}

    tp = to_torch(jp)
    leaves = {k: (v.clone().requires_grad_(True) if not isinstance(v, dict)
                  else {kk: vv.clone().requires_grad_(True)
                        for kk, vv in v.items()})
              for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tblocks.moe_block(leaves, tx, tc)
    flat = [t for v in leaves.values()
            for t in (v.values() if isinstance(v, dict) else [v])]
    grads = torch.autograd.grad([ty, taux], flat + [tx],
                                [torch.from_numpy(cot),
                                 torch.tensor(aux_cot)])
    _close(ty, jy)
    _close(taux, jaux)
    _close(grads[-1], jgx)
    it = iter(grads)
    got = _flat({k: ({kk: next(it) for kk in v} if isinstance(v, dict)
                     else next(it)) for k, v in leaves.items()})
    want = _flat(jax.tree.map(np.asarray, jgp))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=0,
            atol=LEAF_TOL * max(float(np.abs(w).max()), 1e-30), err_msg=k)
    # the training capacity drops slots here (JAX scatters them with
    # mode="drop", the port writes them to a row that is cut off: the
    # gradients above agree, so a dropped slot takes none)
    x2d = torch.from_numpy(x).reshape(-1, jc.d_model)
    _, eidx, _ = tblocks._router(tp, x2d, tc)
    cap = tblocks.moe_capacity(tc, x2d.shape[0], 16, train=True)
    assert cap == 8 < tblocks.moe_capacity(tc, x2d.shape[0], 16)
    load = torch.bincount(eidx.reshape(-1), minlength=tc.moe.num_experts)
    assert int(torch.clamp(load - cap, min=0).sum()) > 0


# --------------------------------------------------------------------------
# (b) loss, gradients, logits, train steps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl,remat", [("kernel", "none"),
                                        ("kernel", "full"),
                                        ("reference", "none")])
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_jax(arch, impl, remat):
    _, tc = _cfgs(arch)
    tc = dataclasses.replace(tc, attention_impl=impl, remat=remat)
    _, _, jparams = _jax_model(arch)
    batch, jo, jw, jaux, jg = _jax_loss_and_grads(arch)
    tmodel = tbuild(tc, "cpu")
    params = params_from_jax(jparams, tc, "cpu")
    _, _, met = tmodel.loss_fn(params, _tb(batch), ce_impl=impl,
                               label_smoothing=0.1)
    (to, tw), tg = value_and_grad(tmodel.loss_fn, params, _tb(batch),
                                  ce_impl=impl, label_smoothing=0.1)
    assert jaux > 0
    np.testing.assert_allclose(float(met["aux"]), jaux, rtol=RTOL)
    np.testing.assert_allclose(float(to), jo, rtol=RTOL)
    assert float(tw) == jw == float(batch["weights"].sum())
    _assert_trees_close(tg, jg, f"{arch} grads")


@pytest.mark.parametrize("arch", MOE)
def test_logits_fn_matches_jax(arch):
    import jax
    import jax.numpy as jnp
    _, tc = _cfgs(arch)
    _, jmodel, jparams = _jax_model(arch)
    params = params_from_jax(jparams, tc, "cpu")
    x = np.random.default_rng(7).integers(0, tc.vocab_size,
                                          (2, 14)).astype(np.int32)
    _close(tbuild(tc, "cpu").logits_fn(params, torch.from_numpy(x)),
           jax.jit(jmodel.logits_fn)(jparams, jnp.asarray(x)))


def _train_cfgs(arch, accum=2, **het):
    from repro.configs import base as jcfgs
    jc, tc = _cfgs(arch)
    tc = dataclasses.replace(tc, attention_impl="kernel")
    shape = ("t", SEQ, 4, "train")
    tj = jcfgs.TrainConfig(
        model=jc, shape=jcfgs.ShapeConfig(*shape),
        het=jcfgs.HetConfig(accum_steps=accum, **het),
        optimizer=jcfgs.OptimizerConfig(**OPT), label_smoothing=0.1)
    tt = tcfgs.TrainConfig(
        model=tc, shape=tcfgs.ShapeConfig(*shape),
        het=tcfgs.HetConfig(accum_steps=accum, **het),
        optimizer=tcfgs.OptimizerConfig(**OPT), label_smoothing=0.1)
    return jc, tc, tj, tt


def _train_batches(cfg, accum, steps=2, seed=5):
    """Packed batches of 4 real rows (the plan's dummy rows carry weight
    0) from a numpy seed."""
    plan = tcap.plan_capacities(4, (1.0,), headroom=1.25,
                                round_buffer_to=accum)
    rng = np.random.default_rng(seed)
    return [_batch(cfg, rng, plan.buffer_rows,
                   dummy_rows=plan.buffer_rows - 4) for _ in range(steps)]


@pytest.mark.parametrize("arch", MOE)
def test_two_train_steps_match_jax(arch):
    import jax
    from jax.sharding import AxisType
    from repro import compat
    from repro.launch import steps as jsteps
    from repro.models.model import build_model as jbuild
    jc, tc, tj, tt = _train_cfgs(arch)
    batches = _train_batches(tc, 2)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jmodel = jbuild(jc)
    jmet = []
    with compat.set_mesh(mesh):
        jstep = jsteps.build_train_step(jmodel, tj, mesh)
        jstate = jsteps.init_train_state(jmodel, tj, mesh,
                                         jax.random.PRNGKey(0))
        params0 = jax.tree.map(np.asarray, jstate.params)
        for b in batches:
            jstate, met = jstep(jstate, _jb(b))
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
    _assert_trees_close(state.params, jstate.params, f"{arch} params")
    _assert_trees_close(state.opt.m, jstate.opt.m, f"{arch} m")
    _assert_trees_close(state.opt.v, jstate.opt.v, f"{arch} v")


def test_canonical_step_routes_each_row_alone():
    """``weighting="canonical"`` runs each row as its own batch (JAX's
    ``per_row_values``), so each row routes at its own training capacity
    and carries its own aux term: the step's loss is the fold of JAX's
    one-row ``loss_fn`` objectives over the weights, and differs from
    the monolithic step's (which routes a microbatch's rows together)."""
    import jax
    from repro.models.blocks import LOCAL_CTX
    _, tc = _cfgs("deepseek-v2-236b")
    tc = dataclasses.replace(tc, attention_impl="kernel")
    _, jmodel, jparams = _jax_model("deepseek-v2-236b")
    b = _train_batches(tc, 1, steps=1)[0]
    row = jax.jit(lambda p, rb: jmodel.loss_fn(p, rb, LOCAL_CTX,
                                               label_smoothing=0.1)[:2])
    sums = [row(jparams, _jb({k: v[i:i + 1] for k, v in b.items()}))
            for i in range(b["weights"].shape[0])]
    want = sum(float(o) for o, _ in sums) / sum(float(w) for _, w in sums)
    losses = {}
    for weighting in ("canonical", "tokens"):
        tt = tcfgs.TrainConfig(
            model=tc, shape=tcfgs.ShapeConfig("t", SEQ, 4, "train"),
            het=tcfgs.HetConfig(weighting=weighting),
            optimizer=tcfgs.OptimizerConfig(**OPT), label_smoothing=0.1)
        params = params_from_jax(jparams, tc, "cpu")
        state = tsteps.TrainState(params=params, opt=tadam.init_state(
            params, tt.optimizer), err=())
        _, met = tsteps.build_train_step(tbuild(tc, "cpu"), tt)(state,
                                                                _tb(b))
        losses[weighting] = float(met["loss"])
    np.testing.assert_allclose(losses["canonical"], want, rtol=RTOL)
    assert abs(losses["tokens"] - want) > 100 * RTOL * want


# --------------------------------------------------------------------------
# (c) the aux term across two ranks
# --------------------------------------------------------------------------

GLOBAL = 6
CAPS = (2.0, 1.0)
# the aux coefficient of the two-rank runs: 100x the configs' 0.01, so
# the two rules' steps differ far beyond the tolerances
AUX_COEF = 1.0
# name: (devices, het fields, whether the routing region spans both
# ranks)
RANK_CONFIGS = {
    "allreduce": ((2, 1), dict(grad_reduction="allreduce"), True),
    "hierarchical": ((1, 2, 1), dict(grad_reduction="hierarchical",
                                     bucket_mb=0.02), True),
    "bucketed_allreduce": ((2, 1), dict(grad_reduction="bucketed_allreduce",
                                        bucket_mb=0.02), False),
    # two pods of one data rank: the region is the rank; int8 across pods
    "hierarchical_int8": ((2, 1, 1), dict(grad_reduction="hierarchical",
                                          compression="int8",
                                          bucket_mb=0.02), False),
}
# the int8 exchange's limits (test_torch_dist_train.py's): a flipped code
# moves an element by one quantization step of its block
INT8 = {"grad_norm": 1e-2, "leaf": 2e-2}


def _rank_tcfg(mc, het):
    return tcfgs.TrainConfig(
        model=mc, shape=tcfgs.ShapeConfig("t", SEQ, GLOBAL, "train"),
        het=tcfgs.HetConfig(accum_steps=2, capacities=CAPS, **het),
        optimizer=tcfgs.OptimizerConfig(**OPT), label_smoothing=0.1)


def _pipe_tcfg(tc):
    """Two pipeline stages, accum 2, fp32, clip 0 (the pipe-axis run)."""
    return tcfgs.TrainConfig(
        model=tc, shape=tcfgs.ShapeConfig("t", SEQ, 4, "train"),
        het=tcfgs.HetConfig(accum_steps=2, pipeline_stages=2),
        optimizer=tcfgs.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                        grad_clip=0.0),
        label_smoothing=0.1)


def _pipe_run(tc, mesh, batch):
    """One pipelined step from the seed's parameters: the loss and the
    parameters this process holds, by path in the full tree."""
    model = tbuild(tc, "cpu")
    tcfg = _pipe_tcfg(tc)
    first = tsteps.stage_plan_for(model, tcfg).stage_ranges()[
        mesh.pipe_index][0]
    state = tsteps.init_train_state(model, tcfg, mesh=mesh)
    state, met = tsteps.build_train_step(model, tcfg, mesh)(state,
                                                            _tb(batch))
    return float(met["loss"]), {
        tsteps._global_path(path, first): t.detach().numpy().copy()
        for path, t in tsteps._paths(state.params)}


def aux_rank(rank, world, init_method, params0, packed, buffer_rows,
             pipe_batch):
    """One gloo rank: one step of each config on this rank's rows, then
    one pipelined step with each stage on its own rank (a ``pipe``
    axis) on the whole of ``pipe_batch``."""
    mesh_mod.share_cpu(world)
    out = {}
    mc = tcfgs.smoke_config("deepseek-v2-236b")
    mc = dataclasses.replace(
        mc, compute_dtype="float32", attention_impl="kernel",
        moe=dataclasses.replace(mc.moe, aux_loss_coef=AUX_COEF))
    for name, (devices, het, _) in RANK_CONFIGS.items():
        axes = ("data", "model") if len(devices) == 2 else (
            "pod", "data", "model")
        mesh = mesh_mod.init(devices, axes, rank, init_method, "cpu")
        tcfg = _rank_tcfg(mc, het)
        model = tbuild(mc, "cpu")
        params = params_from_jax(params0, mc, "cpu")
        state = tsteps.init_train_state(model, tcfg, mesh=mesh)
        state = tsteps.TrainState(params=params, opt=state.opt,
                                  err=state.err)
        step = tsteps.build_train_step(model, tcfg, mesh)
        mine = {k: torch.from_numpy(np.ascontiguousarray(
            v[rank * buffer_rows:(rank + 1) * buffer_rows]))
            for k, v in packed.items()}
        state, met = step(state, mine)
        out[name] = {"loss": float(met["loss"]),
                     "grad_norm": float(met["grad_norm"]),
                     "checksum": tsteps.params_checksum(state.params),
                     "params": params_to_numpy(state.params)
                     if rank == 0 else None}
    shape, axes = mesh_mod.with_pipe((1, 1), ("data", "model"), 2)
    mesh = mesh_mod.init(shape, axes, rank, init_method, "cpu")
    out["pipe_axis"] = _pipe_run(
        dataclasses.replace(mc, scan_layers=False), mesh, pipe_batch)
    mesh_mod.destroy(mesh)
    return out


def _jax_two_rank_steps(jmodel, jparams, packed, buffer_rows):
    """One AdamW step of the JAX objective of each rule, built from the
    one-device ``loss_fn`` on each rank's rows of each microbatch: its
    CE sum, aux loss and weight sum and their gradients (one jitted
    function, four calls), combined by the rule. Returns {region?:
    (loss, grad norm, params)}."""
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jcfgs
    from repro.models.blocks import LOCAL_CTX
    from repro.optim import adam as jadam
    from repro.optim import schedules as jsched
    half = buffer_rows // 2

    def parts(p, mb):
        _, w, met = jmodel.loss_fn(p, mb, LOCAL_CTX, label_smoothing=0.1)
        return met["ce_sum"], met["aux"], w

    f = jax.jit(lambda p, mb: (parts(p, mb), jax.jacrev(
        lambda q: parts(q, mb)[:2])(p)))
    params = jax.tree.map(jnp.asarray, jparams)
    # pieces[m][r]: ((ce, aux, w), (d ce, d aux)) of rank r's microbatch m
    pieces = [[f(params, {k: jnp.asarray(
        v[r * buffer_rows + m * half:r * buffer_rows + (m + 1) * half])
        for k, v in packed.items()}) for r in range(2)] for m in range(2)]
    ocfg = jcfgs.OptimizerConfig(**OPT)
    lr = jsched.learning_rate(ocfg, jnp.int32(1))
    update = jax.jit(lambda p, g: jadam.apply_update(
        p, g, jadam.init_state(p, ocfg), ocfg, lr))
    out = {}
    for region in (True, False):
        o_tot, w_tot, g_tot = 0.0, 0.0, None
        for mb in pieces:
            big_w = mb[0][0][2] + mb[1][0][2]
            for (ce, aux, w), (dce, daux) in mb:
                a = big_w / 2 if region else w
                o_tot = o_tot + ce + aux * a
                g = jax.tree.map(lambda x, y: x + y * a, dce, daux)
                g_tot = g if g_tot is None else jax.tree.map(jnp.add, g_tot,
                                                             g)
            w_tot = w_tot + big_w
        new, _, met = update(params, jax.tree.map(lambda x: x / w_tot,
                                                  g_tot))
        out[region] = (float(o_tot / w_tot), float(met["grad_norm"]), new)
    return out


@pytest.fixture(scope="module")
def two_rank_runs():
    from repro.models.model import build_model as jbuild
    jc, tc = _cfgs("deepseek-v2-236b", moe=dict(aux_loss_coef=AUX_COEF))
    jmodel = jbuild(jc)
    jparams = _jax_model("deepseek-v2-236b")[2]
    plan = tcap.plan_capacities(GLOBAL, CAPS, headroom=1.25,
                                round_buffer_to=2)
    assert plan.rows_per_rank[0] != plan.rows_per_rank[1]
    rng = np.random.default_rng(11)
    samples = {k: rng.integers(0, tc.vocab_size, (GLOBAL, SEQ)).astype(
        np.int32) for k in ("inputs", "labels")}
    packed = tdummy.pack_global_batch(samples, plan)
    pipe_batch = _train_batches(tc, 2, steps=1)[0]
    per_rank = mesh_mod.spawn(aux_rank, 2, (jparams, packed,
                                            plan.buffer_rows, pipe_batch),
                              timeout_s=600)
    return per_rank, _jax_two_rank_steps(jmodel, jparams, packed,
                                         plan.buffer_rows)


@pytest.mark.parametrize("name", list(RANK_CONFIGS))
def test_two_rank_aux_combination_matches_jax(name, two_rank_runs):
    per_rank, want = two_rank_runs
    region = RANK_CONFIGS[name][2]
    int8 = "compression" in RANK_CONFIGS[name][1]
    loss, gnorm, params = want[region]
    other = want[not region]
    # the two rules give different steps here, beyond the tolerances
    assert abs(other[1] - gnorm) > 100 * GNORM_RTOL * gnorm
    ranks = [r[name] for r in per_rank]
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=RTOL)
    np.testing.assert_allclose(ranks[0]["grad_norm"], gnorm,
                               rtol=INT8["grad_norm"] if int8
                               else GNORM_RTOL)
    import jax
    got = _flat(ranks[0]["params"])
    want = _flat(jax.tree.map(np.asarray, params))
    assert set(got) == set(want)
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = np.abs(got[path] - w)
        if int8:
            assert err.max() <= INT8["leaf"] * scale, (name, path)
            continue
        off = int(np.sum(err > LEAF_TOL * scale))
        assert off <= -(-err.size // 10_000), (name, path, off)
        assert err.max() <= OUTLIER_TOL * scale, (name, path)


def test_pipe_axis_stage_ranks_bitwise_one_process(two_rank_runs):
    """Two stages on their own gloo ranks (the aux carry and its
    cotangent crossing between them with the activations) bitwise the
    one-process pipelined step, itself bitwise the monolithic step (d)."""
    per_rank, _ = two_rank_runs
    _, tc = _cfgs("deepseek-v2-236b", scan_layers=False)
    mc = dataclasses.replace(tc, attention_impl="kernel",
                             moe=dataclasses.replace(tc.moe,
                                                     aux_loss_coef=AUX_COEF))
    want_loss, want = _pipe_run(mc, mesh_mod.local(device="cpu"),
                                _train_batches(tc, 2, steps=1)[0])
    got = {}
    for r in per_rank:
        loss, held = r["pipe_axis"]
        assert loss == want_loss
        for path, a in held.items():
            if path in got:                     # a tied table's copy
                assert np.array_equal(got[path], a), path
            got[path] = a
    assert set(got) == set(want)
    for path, w in want.items():
        assert np.array_equal(got[path], w), path


# --------------------------------------------------------------------------
# (d) the step builders on the MoE/MLA stack
# --------------------------------------------------------------------------


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


def test_step_builders_bitwise_on_deepseek():
    """``overlap="backward"`` and ``"buckets"`` and two pipeline stages
    (1F1B, GPipe) bitwise the monolithic step (bucketed_allreduce, fp32,
    clip 0): the aux carry's cotangent reaches every MoE layer as in the
    monolithic backward."""
    _, tc = _cfgs("deepseek-v2-236b", scan_layers=False)
    tc = dataclasses.replace(tc, attention_impl="kernel")
    batches = _train_batches(tc, 2)

    def tcfg(**het):
        return tcfgs.TrainConfig(
            model=tc, shape=tcfgs.ShapeConfig("t", SEQ, 4, "train"),
            het=tcfgs.HetConfig(grad_reduction="bucketed_allreduce",
                                bucket_mb=0.02, accum_steps=2, **het),
            optimizer=tcfgs.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                            grad_clip=0.0),
            label_smoothing=0.1)

    want = _steps_run(tc, tcfg(), batches)
    for het in (dict(overlap="backward"), dict(overlap="buckets"),
                dict(pipeline_stages=2, pipeline_schedule="1f1b"),
                dict(pipeline_stages=2, pipeline_schedule="gpipe")):
        got = _steps_run(tc, tcfg(**het), batches)
        assert got[0] == want[0], het
        assert all(np.array_equal(got[1][k], want[1][k])
                   for k in want[1]), het


@pytest.mark.parametrize("arch", MOE)
def test_train_driver_trains_the_moe_archs(arch):
    """``python -m repro_torch.launch.train --arch <arch> --smoke --device
    cpu``: the loss falls, every step finite."""
    from repro_torch.launch import train as ttrain
    out = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "4", "--global-batch", "8", "--seq-len",
                       "16", "--accum", "2", "--lr", "3e-3", "--warmup",
                       "1", "--schedule", "constant", "--log-every", "4"])
    assert out["steps"] == 4 and all(np.isfinite(out["losses"]))
    assert out["last_loss"] < out["first_loss"]


# --------------------------------------------------------------------------
# (e) the optimizer policy and the blocked update
# --------------------------------------------------------------------------


def test_optimizer_for_matches_jax():
    from repro.configs import base as jcfgs
    archs = jcfgs.list_archs()
    assert len(archs) == 10
    for arch in archs:
        for kw in ({}, {"lr": 1e-2, "m_dtype": "float32"}):
            got = tcfgs.optimizer_for(tcfgs.resolve(arch), **kw)
            want = jcfgs.optimizer_for(jcfgs.resolve(arch), **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
    assert tcfgs.optimizer_for(tcfgs.resolve("deepseek-v2-236b")).m_dtype \
        == "bfloat16"


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_update_in_row_blocks_is_bitwise_the_whole_leaf(clip, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    shapes = {"a": (7, 5, 3), "b": (11,), "c": (4, 9)}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=gen) * 5 for k, s in shapes.items()}
    ocfg = tcfgs.OptimizerConfig(grad_clip=clip, m_dtype="bfloat16")
    runs = []
    for chunk in (tadam.UPDATE_CHUNK, 16):
        monkeypatch.setattr(tadam, "UPDATE_CHUNK", chunk)
        p = {k: v.clone() for k, v in params.items()}
        state = tadam.init_state(p, ocfg)
        for _ in range(2):
            p, state, met = tadam.apply_update(p, grads, state, ocfg,
                                               torch.tensor(1e-2))
        runs.append((p, state, met))
    assert len(list(tadam.row_blocks(params["a"]))) == 7
    (p0, s0, m0), (p1, s1, m1) = runs
    for k in shapes:
        assert torch.equal(p0[k], p1[k]) and torch.equal(s0.m[k], s1.m[k])
        assert torch.equal(s0.v[k], s1.v[k])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
