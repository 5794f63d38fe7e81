"""Mamba2 and zamba training in repro_torch against the JAX package (CPU,
fp32, smoke configs, numpy-seeded inputs, JAX's parameters carried over).

  (a) ``ssd_scan_bwd_plain`` (the SSD backward kernel's arithmetic step
      by step) against ``jax.vjp`` of JAX's ``ref.ssd_chunked``, all six
      gradients, the final state's cotangent 0: a multiple of the chunk,
      a ragged tail, S below the chunk, one and two groups, with and
      without D (relative L2 of each gradient, ``SSD_TOL``);
  (b) ``SSDScanFn`` on CPU tensors (the wrappers' plain versions)
      against torch autograd through the port's ``ref.ssd_chunked``, in
      fp32 and bf16 (``SSD_TOL``; bf16 ``BF16_TOL``: both round the same
      bf16 inputs' gradients once); a gradient reaching the final state
      raises; the kernel dispatch goes through it only when a gradient
      is wanted;
  (c) ``flash_attention_bwd_plain`` at head dim 80 (zamba2's shared
      block) against JAX's ``ref._flash_bwd`` (``TOL``);
  (d) ``mamba_block``'s output and the gradients of its parameters and
      input under one cotangent against ``jax.vjp`` of JAX's, at impl
      "kernel" and "reference" (``TOL`` relative to max(1, max |want|);
      gradients ``LEAF_TOL`` of each leaf's largest magnitude);
  (e) zamba2 smoke and its ``mamba``-plan variant (hybrid off):
      ``loss_fn`` and every leaf's gradient against
      ``jax.value_and_grad`` at remat "none" and "full" (loss ``RTOL``,
      gradients ``LEAF_TOL``), and two AdamW train steps against JAX's
      ``build_train_step`` on a (1, 1) mesh of Auto axes (loss, grad
      norm, parameters and moments); the config checks refuse
      ``overlap="backward"`` and pipeline stages with JAX's messages;
  (f) the HetSeq invariant on zamba2 smoke: capacities 2,1,1,0 through
      ``simulate_workers`` and ``accumulate_grads`` give the
      single-process loss and gradient over the real rows;
  (g) ``overlap="buckets"`` bitwise the monolithic step at fp32 and clip
      0, ``weighting="canonical"`` within the fp32 tolerances of it (it
      runs each row alone: other matmul shapes; parameters by each
      leaf's relative L2, as ``test_torch_archs.py`` holds the stub
      archs' canonical step); two gloo ranks
      (``hierarchical``, int8, capacities 2,1, one step) against one
      process's step over the union of the real rows, to
      ``test_torch_dist_train.py``'s int8 limits (loss, grad norm), and
      the first moment (the gradient scaled) within ``INT8_GRAD``
      relative L2 over the whole tree (after one AdamW step from a zero
      init a parameter moves by about lr times the sign of its gradient,
      which the exchange's noise flips where the gradient is near 0, so
      the parameters are not compared leaf by leaf);
  (h) the train driver trains zamba2 smoke on the CPU, and its resume
      from a checkpoint is bitwise the uninterrupted run.

The JAX sides are computed once, in module-scoped fixtures.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tcfgs
from repro_torch.core import capacity as tcap
from repro_torch.core import dummy as tdummy
from repro_torch.core import weighting as tweighting
from repro_torch.core.accumulate import accumulate_grads, value_and_grad
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.parity import rel_l2
from repro_torch.kernels.ssd_scan import ops as tops
from repro_torch.kernels.ssd_scan import ref as tref
from repro_torch.kernels.ssd_scan import ssd_scan as tsk
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as tsteps
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import build_model as tbuild
from repro_torch.optim import adam as tadam

ARCH = "zamba2-2.7b"
SSD_TOL = 2e-5       # relative L2 of a gradient (fp32, another order)
BF16_TOL = 1e-2      # relative L2 of a bf16-rounded gradient
TOL = 2e-5           # outputs, relative to max(1, max |want|)
RTOL = 1e-5          # losses
GNORM_RTOL = 1e-4
LEAF_TOL = 1e-4      # of each leaf's largest magnitude
# the int8 exchange's limits (test_torch_dist_train.py's)
INT8 = {"loss": 1e-4, "grad_norm": 1e-2}
# the int8 exchange's gradient against the exact one, relative L2 over
# the whole tree: a flipped code moves an element by 1/127 of its
# 256-element block's largest value
INT8_GRAD = 1e-2
SEQ = 40             # a ragged tail at the smoke config's chunk of 32
OPT = dict(lr=1e-3, warmup_steps=1, schedule="constant", total_steps=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(hybrid=True, **kw):
    from repro.configs import base as jcfgs
    jc = dataclasses.replace(jcfgs.smoke_config(ARCH),
                             compute_dtype="float32", **kw)
    tc = dataclasses.replace(tcfgs.smoke_config(ARCH),
                             compute_dtype="float32", **kw)
    if not hybrid:
        jc = dataclasses.replace(jc, hybrid=dataclasses.replace(
            jc.hybrid, enabled=False))
        tc = dataclasses.replace(tc, hybrid=dataclasses.replace(
            tc.hybrid, enabled=False))
    return jc, tc


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
        assert got[path].shape == w.shape, (what, path)
        atol = tol * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg=f"{what} {path}")


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
# (a), (b) the SSD backward
# --------------------------------------------------------------------------

# b, s, h, p, g, n, chunk, with D
SSD_BWD_CASES = [
    (2, 64, 4, 16, 1, 16, 16, True),         # a multiple of the chunk
    (2, 50, 4, 16, 2, 16, 16, True),         # a ragged tail, two groups
    (1, 10, 4, 8, 1, 16, 32, False),         # S below the chunk, no D
    (1, 100, 8, 32, 1, 64, 64, True),        # the kernel's N
]


def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = f(b, s, h, p)
    dt = np.log1p(np.exp(f(b, s, h) - 1.0))             # softplus
    A = -np.exp(f(h) * 0.5)
    Bm, Cm = f(b, s, g, n) * 0.3, f(b, s, g, n) * 0.3
    D = f(h)
    dy = f(b, s, h, p)
    return x, dt, A, Bm, Cm, D, dy


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,with_d", SSD_BWD_CASES)
def test_ssd_bwd_plain_matches_jax_vjp(b, s, h, p, g, n, chunk, with_d):
    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ref as jref
    x, dt, A, Bm, Cm, D, dy = _ssd_inputs(b * s + h, b, s, h, p, g, n)
    if not with_d:
        D = None
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jd = [jnp.asarray(D)] if with_d else []

    def f(*args):
        y, _ = jref.ssd_chunked(*args[:5], args[5] if with_d else None,
                                chunk_size=chunk)
        return y

    want = jax.jit(lambda c, *args: jax.vjp(f, *args)[1](c))(
        jnp.asarray(dy), *j, *jd)
    t = [torch.from_numpy(a) if a is not None else None
         for a in (x, dt, A, Bm, Cm, D, dy)]
    got = tsk.ssd_scan_bwd_plain(*t, chunk_size=chunk)
    assert got[0].shape == x.shape and got[1].shape == dt.shape
    assert got[3].shape == Bm.shape and got[4].shape == Cm.shape
    assert all(a.dtype == torch.float32 for a in got if a is not None)
    assert (got[5] is None) == (not with_d)
    for name, gv, wv in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got,
                            want):
        err = rel_l2(gv, torch.from_numpy(np.asarray(wv)))
        assert err <= SSD_TOL, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [SSD_BWD_CASES[1], SSD_BWD_CASES[3]])
def test_ssd_scan_fn_on_cpu_matches_autograd(case, dtype):
    b, s, h, p, g, n, chunk, _ = case
    x, dt, A, Bm, Cm, D, dy = (torch.from_numpy(a) for a in _ssd_inputs(
        7, b, s, h, p, g, n))
    x, Bm, Cm, dy = (t.to(dtype) for t in (x, Bm, Cm, dy))

    def leaves():
        return [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm,
                                                           D)]

    ins = leaves()
    tsk.ssd_scan_bwd_cuda.launches = 0
    y, final = tsk.SSDScanFn.apply(*ins, chunk)
    assert final.dtype == torch.float32 and y.dtype == dtype
    got = torch.autograd.grad(y, ins, dy)
    assert tsk.ssd_scan_bwd_cuda.launches == 0      # the CPU plain version
    ref_ins = leaves()
    y_ref, _ = tref.ssd_chunked(*ref_ins, chunk_size=chunk)
    want = torch.autograd.grad(y_ref, ref_ins, dy)
    assert torch.equal(y, y_ref)
    tol = SSD_TOL if dtype == torch.float32 else BF16_TOL
    for name, gv, wv in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got,
                            want):
        assert gv.dtype == wv.dtype, name
        assert rel_l2(gv, wv) <= tol, (name, rel_l2(gv, wv))
    # the final state takes no gradient: reaching it raises
    ins = leaves()
    y, final = tsk.SSDScanFn.apply(*ins, chunk)
    with pytest.raises(RuntimeError, match="final state"):
        torch.autograd.grad((y.float().sum() + final.sum()), ins)


def test_kernel_dispatch_differentiates_only_when_asked(monkeypatch):
    x, dt, A, Bm, Cm, D, _ = (torch.from_numpy(a) for a in _ssd_inputs(
        3, 1, 20, 4, 8, 1, 16))
    calls = []
    real = tsk.SSDScanFn.apply
    monkeypatch.setattr(tops.SSDScanFn, "apply",
                        lambda *a: calls.append(1) or real(*a))
    y0, _ = tops.ssd_scan(x, dt, A, Bm, Cm, D, chunk_size=16, impl="kernel")
    assert not calls
    xg = x.clone().requires_grad_(True)
    y1, _ = tops.ssd_scan(xg, dt, A, Bm, Cm, D, chunk_size=16, impl="kernel")
    assert calls and y1.requires_grad and torch.equal(y1.detach(), y0)
    with torch.no_grad():
        tops.ssd_scan(xg, dt, A, Bm, Cm, D, chunk_size=16, impl="kernel")
    assert len(calls) == 1


def test_ssd_bwd_wrapper_runs_the_plain_version_on_cpu_only():
    """CPU tensors take the plain version and count no launch; tensors on
    any other device than the CPU or a card raise (no fallback)."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(4, 1, 20, 4, 8, 1,
                                                     16)]
    tsk.ssd_scan_bwd_cuda.launches = 0
    got = tsk.ssd_scan_bwd_cuda(*args, chunk_size=16)
    want = tsk.ssd_scan_bwd_plain(*args, chunk_size=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tsk.ssd_scan_bwd_cuda.launches == 0
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tsk.ssd_scan_bwd_cuda(*[t.to("meta") for t in args])


# --------------------------------------------------------------------------
# (c) kernel 1b's plain version at head dim 80
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,hkv", [(2, 48, 4, 4), (1, 37, 4, 2)])
def test_flash_bwd_plain_at_d80_matches_jax(b, s, h, hkv):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import ref as jfref
    assert 80 in tfa.BWD_HEAD_DIMS and tfa.BWD_TILES[80] == (64,) * 4
    rng = np.random.default_rng(s)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, k, v, dout = f(b, s, h, 80), f(b, s, hkv, 80), f(b, s, hkv, 80), \
        f(b, s, h, 80)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = tfa.flash_attention_plain(tq, tk, tv, causal=True,
                                         return_lse=True)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, out, lse,
                                        torch.from_numpy(dout))
    res = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
           jnp.full((b,), s, jnp.int32),
           jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()))
    want = jfref._flash_bwd(True, 0, 80 ** -0.5, 16, res,
                            jnp.asarray(dout))
    for gv, wv in zip(got, want[:3]):
        w = np.asarray(wv)
        np.testing.assert_allclose(gv.numpy(), w, rtol=0,
                                   atol=TOL * max(1.0, np.abs(w).max()))


# --------------------------------------------------------------------------
# (d) the Mamba2 block under autograd
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_mamba_block_grads_match_jax_vjp(impl):
    import jax
    import jax.numpy as jnp
    from repro.models import blocks as jblocks
    from repro.models import ssm as jssm
    jc, tc = _cfgs()
    tc = dataclasses.replace(tc, attention_impl=impl)
    rng = np.random.default_rng(3)
    jp0 = jax.tree.map(np.asarray, jssm.init_mamba(jc,
                                                   jax.random.PRNGKey(0)))
    jp = {}
    for k, v in jp0.items():              # the zero and one inits redrawn
        r = rng.standard_normal(v.shape).astype(np.float32)
        jp[k] = (v + 0.1 * r if k in ("A_log", "in_proj", "out_proj")
                 else r * (0.1 if k in ("conv_b", "dt_bias") else 1.0))
    x = rng.standard_normal((2, SEQ, jc.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jfn(p, xx, c):
        out, vjp = jax.vjp(lambda q, z: jssm.mamba_block(
            q, z, jc, jblocks.LOCAL_CTX), p, xx)
        return out, vjp(c)

    jy, (jgp, jgx) = jax.jit(jfn)({k: jnp.asarray(v) for k, v in jp.items()},
                                  jnp.asarray(x), jnp.asarray(cot))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tssm.mamba_block(tp, tx, tc)
    grads = torch.autograd.grad(ty, list(tp.values()) + [tx],
                                torch.from_numpy(cot))
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=0,
                               atol=TOL * max(1.0, np.abs(jy).max()))
    want = {**{k: np.asarray(v) for k, v in jgp.items()},
            "x": np.asarray(jgx)}
    for name, g in zip(list(tp) + ["x"], grads):
        w = want[name]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=LEAF_TOL * max(float(np.abs(w).max()), 1e-30), err_msg=name)


# --------------------------------------------------------------------------
# (e) loss, gradients and train steps against JAX
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_side(hybrid):
    """(JAX parameters at seed 0, the batch, JAX's objective, weight and
    gradient), jitted, once per plan."""
    import jax
    from repro.models.blocks import LOCAL_CTX
    from repro.models.model import build_model as jbuild
    jc, _ = _cfgs(hybrid)
    jmodel = jbuild(jc)
    jparams = jax.tree.map(np.asarray, jax.jit(jmodel.init_params)(
        jax.random.PRNGKey(0)))
    batch = _batch(jc, np.random.default_rng(1), 3)

    def jobj(p, b):
        o, w, _ = jmodel.loss_fn(p, b, LOCAL_CTX, label_smoothing=0.1)
        return o, w

    (jo, jw), jg = jax.jit(jax.value_and_grad(jobj, has_aux=True))(
        jparams, _jb(batch))
    return jparams, batch, float(jo), float(jw), jg


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("impl", ["kernel", "reference"])
@pytest.mark.parametrize("hybrid", [True, False])
def test_loss_and_grads_match_jax(hybrid, impl, remat):
    _, tc = _cfgs(hybrid, remat=remat)
    tc = dataclasses.replace(tc, attention_impl=impl)
    assert ttr.stack_plan(tc) == ("zamba" if hybrid else "mamba")
    jparams, batch, jo, jw, jg = _jax_side(hybrid)
    model = tbuild(tc, "cpu")
    params = params_from_jax(jparams, tc, "cpu")
    (to, tw), tg = value_and_grad(model.loss_fn, params, _tb(batch),
                                  ce_impl=impl, label_smoothing=0.1)
    np.testing.assert_allclose(float(to), jo, rtol=RTOL)
    assert float(tw) == jw == float(batch["weights"].sum())
    # the shared block's leaves take the sum over its applications
    _assert_trees_close(tg, jg, f"{ttr.stack_plan(tc)} grads")


def _train_cfgs(hybrid, accum=2, **het):
    from repro.configs import base as jcfgs
    jc, tc = _cfgs(hybrid)
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
    plan = tcap.plan_capacities(4, (1.0,), headroom=1.25,
                                round_buffer_to=accum)
    rng = np.random.default_rng(seed)
    return [_batch(cfg, rng, plan.buffer_rows,
                   dummy_rows=plan.buffer_rows - 4) for _ in range(steps)]


@pytest.mark.parametrize("hybrid", [True, False])
def test_two_train_steps_match_jax(hybrid):
    import jax
    from jax.sharding import AxisType
    from repro import compat
    from repro.launch import steps as jsteps
    from repro.models.model import build_model as jbuild
    jc, tc, tj, tt = _train_cfgs(hybrid)
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
    _assert_trees_close(state.params, jstate.params, "params")
    _assert_trees_close(state.opt.m, jstate.opt.m, "m")
    _assert_trees_close(state.opt.v, jstate.opt.v, "v")


@pytest.mark.parametrize("het", [
    dict(overlap="backward", bucket_mb=0.05,
         grad_reduction="bucketed_allreduce"),
    dict(pipeline_stages=2, accum_steps=2)])
@pytest.mark.parametrize("hybrid", [True, False])
def test_staged_modes_are_refused_as_jax_refuses_them(hybrid, het):
    import jax
    from repro.configs import base as jcfgs
    from repro.launch import steps as jsteps
    from repro.models.model import build_model as jbuild
    jc, tc = _cfgs(hybrid, scan_layers=False)
    with pytest.raises(ValueError) as jerr:
        jsteps.validate_train_config(jbuild(jc), jcfgs.TrainConfig(
            model=jc, het=jcfgs.HetConfig(**het)),
            jax.make_mesh((1, 1), ("data", "model")))
    with pytest.raises(ValueError) as terr:
        tsteps.validate_train_config(tbuild(tc, "cpu"), tcfgs.TrainConfig(
            model=tc, het=tcfgs.HetConfig(**het)),
            mesh_mod.local((1, 1), ("data", "model")))
    assert str(terr.value) == str(jerr.value)
    assert not ttr.supports_staged_backward(tc)
    with pytest.raises(ValueError, match="uniform stack plan"):
        ttr.pipeline_stage_fns(tc, [(0, 2), (2, tc.num_layers)])


# --------------------------------------------------------------------------
# (f) the HetSeq invariant
# --------------------------------------------------------------------------


def test_simulated_workers_equal_single_process():
    """Capacities 2,1,1,0: any split of the real rows over workers, the
    zero-capacity one running an all-dummy buffer, aggregates to the
    single-process loss and gradient (kernel path, remat full)."""
    _, tc = _cfgs(remat="full")
    model = tbuild(dataclasses.replace(tc, attention_impl="kernel"), "cpu")
    params = model.init_params(0)
    rng = np.random.default_rng(11)
    rows = 8
    samples = {"inputs": rng.integers(0, tc.vocab_size, (rows, SEQ)),
               "labels": rng.integers(0, tc.vocab_size, (rows, SEQ))}
    (o, w), g = value_and_grad(model.loss_fn, params, _tb({
        **samples, "weights": np.ones((rows, SEQ), np.float32)}))
    want_loss = tweighting.finalize(o, w)
    want = tweighting.scale_grads(g, w)
    plan = tcap.plan_capacities(rows, (2.0, 1.0, 1.0, 0.0), headroom=1.25)
    packed = tdummy.pack_global_batch(samples, plan)
    b = plan.buffer_rows
    workers = [_tb({k: v[r * b:(r + 1) * b] for k, v in packed.items()})
               for r in range(plan.num_ranks)]
    assert any(not wb["weights"].any() for wb in workers)   # a dummy rank
    loss, grads = tweighting.simulate_workers(model.loss_fn, params,
                                              workers)
    stacked = {k: torch.stack([wb[k] for wb in workers])
               for k in workers[0]}
    acc_grads, acc_loss, acc_w = accumulate_grads(model.loss_fn, params,
                                                  stacked)
    assert float(acc_w) == rows * SEQ
    for got_loss, got in ((loss, grads), (acc_loss, acc_grads)):
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=RTOL)
        for gl, wl in zip(ttr.tree_leaves(got), ttr.tree_leaves(want)):
            tol = LEAF_TOL * float(wl.abs().max())
            torch.testing.assert_close(gl, wl, rtol=0, atol=tol)


# --------------------------------------------------------------------------
# (g) the step modes: overlap, canonical, two ranks with int8
# --------------------------------------------------------------------------


def _step_run(tc, tcfg, batches, mesh=None):
    model = tbuild(tc, "cpu")
    mesh = mesh or mesh_mod.local(device="cpu")
    state = tsteps.init_train_state(model, tcfg, mesh=mesh)
    step = tsteps.build_train_step(model, tcfg, mesh)
    losses = []
    for b in batches:
        state, met = step(state, _tb(b))
        losses.append(float(met["loss"]))
    return losses, _flat(params_to_numpy(state.params))


def _mode_tcfg(tc, accum=2, **het):
    return tcfgs.TrainConfig(
        model=tc, shape=tcfgs.ShapeConfig("t", SEQ, 4, "train"),
        het=tcfgs.HetConfig(accum_steps=accum, **het),
        optimizer=tcfgs.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                        grad_clip=0.0),
        label_smoothing=0.1)


def test_overlap_buckets_bitwise_and_canonical_close_to_monolithic():
    _, tc = _cfgs(remat="full")
    tc = dataclasses.replace(tc, attention_impl="kernel")
    batches = _train_batches(tc, 2)
    reduce = dict(grad_reduction="bucketed_allreduce", bucket_mb=0.02)
    want = _step_run(tc, _mode_tcfg(tc, **reduce), batches)
    got = _step_run(tc, _mode_tcfg(tc, overlap="buckets", **reduce),
                    batches)
    assert got[0] == want[0]
    assert all(np.array_equal(got[1][k], want[1][k]) for k in want[1])
    one = [_train_batches(tc, 1, steps=1)[0]]
    want = _step_run(tc, _mode_tcfg(tc, accum=1), one)
    got = _step_run(tc, _mode_tcfg(tc, accum=1, weighting="canonical"), one)
    # per leaf by relative L2, as test_torch_archs.py holds the stub
    # archs' canonical step: one AdamW step moves an element whose
    # gradient sits at its sum's rounding noise by about lr times a sign
    # that the row-by-row order can flip (ROADMAP §3)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    for k, w in want[1].items():
        rel = np.linalg.norm(got[1][k] - w) / np.linalg.norm(w)
        assert rel <= LEAF_TOL, (k, rel)


RANK_CAPS = (2.0, 1.0)
RANK_GLOBAL = 6


def _rank_tcfg(tc, **het):
    return tcfgs.TrainConfig(
        model=tc, shape=tcfgs.ShapeConfig("t", SEQ, RANK_GLOBAL, "train"),
        het=tcfgs.HetConfig(capacities=RANK_CAPS, **het),
        optimizer=tcfgs.OptimizerConfig(**OPT), label_smoothing=0.1)


def int8_rank(rank, world, init_method, packed, buffer_rows):
    """One gloo rank of the hierarchical int8 step (two pods of one data
    rank) on its rows of ``packed``: loss, grad norm, first moment."""
    mesh_mod.share_cpu(world)
    _, tc = _cfgs(remat="full")
    tc = dataclasses.replace(tc, attention_impl="kernel")
    tcfg = _rank_tcfg(tc, grad_reduction="hierarchical", compression="int8",
                      bucket_mb=0.02)
    mesh = mesh_mod.init((2, 1, 1), ("pod", "data", "model"), rank,
                         init_method, "cpu")
    model = tbuild(tc, "cpu")
    state = tsteps.init_train_state(model, tcfg, mesh=mesh)
    step = tsteps.build_train_step(model, tcfg, mesh)
    mine = {k: torch.from_numpy(np.ascontiguousarray(
        v[rank * buffer_rows:(rank + 1) * buffer_rows]))
        for k, v in packed.items()}
    state, met = step(state, mine)
    out = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
           "checksum": tsteps.params_checksum(state.params),
           "m": params_to_numpy(state.opt.m) if rank == 0 else None}
    mesh_mod.destroy(mesh)
    return out


def test_two_ranks_hierarchical_int8_match_one_process():
    _, tc = _cfgs(remat="full")
    tc = dataclasses.replace(tc, attention_impl="kernel")
    plan = tcap.plan_capacities(RANK_GLOBAL, RANK_CAPS, headroom=1.25)
    assert plan.rows_per_rank[0] != plan.rows_per_rank[1]
    rng = np.random.default_rng(13)
    samples = {k: rng.integers(0, tc.vocab_size, (RANK_GLOBAL, SEQ)).astype(
        np.int32) for k in ("inputs", "labels")}
    packed = tdummy.pack_global_batch(samples, plan)
    ranks = mesh_mod.spawn(int8_rank, 2, (packed, plan.buffer_rows),
                           timeout_s=600)
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    # one process, the union of the real rows
    model = tbuild(tc, "cpu")
    tcfg = dataclasses.replace(_rank_tcfg(tc), het=tcfgs.HetConfig())
    state = tsteps.init_train_state(model, tcfg)
    union = _tb({**samples, "weights": np.ones((RANK_GLOBAL, SEQ),
                                               np.float32)})
    state, met = tsteps.build_train_step(model, tcfg)(state, union)
    np.testing.assert_allclose(ranks[0]["loss"], float(met["loss"]),
                               rtol=INT8["loss"])
    np.testing.assert_allclose(ranks[0]["grad_norm"], float(met["grad_norm"]),
                               rtol=INT8["grad_norm"])
    got, want = _flat(ranks[0]["m"]), _flat(params_to_numpy(state.opt.m))
    g = np.concatenate([got[k].reshape(-1) for k in sorted(want)])
    w = np.concatenate([want[k].reshape(-1) for k in sorted(want)])
    assert np.linalg.norm(g - w) <= INT8_GRAD * np.linalg.norm(w)


# --------------------------------------------------------------------------
# (h) the driver
# --------------------------------------------------------------------------


def test_train_driver_trains_zamba2_smoke():
    """``python -m repro_torch.launch.train --arch zamba2-2.7b --smoke
    --device cpu``: the loss falls, every step finite."""
    from repro_torch.launch import train as ttrain
    out = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "4", "--global-batch", "8", "--seq-len",
                       "32", "--accum", "2", "--lr", "3e-3", "--warmup",
                       "1", "--schedule", "constant", "--log-every", "4"])
    assert out["steps"] == 4 and all(np.isfinite(out["losses"]))
    assert out["last_loss"] < out["first_loss"]


def test_driver_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """A checkpoint of zamba2 smoke at step 2 (the shared block's leaves
    in the JAX layout beside the stacked layers), resumed to step 3,
    gives the uninterrupted run's loss and parameters bit for bit."""
    from repro_torch.launch import train as ttrain
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--global-batch",
            "8", "--seq-len", "32", "--log-every", "4"]
    ck = str(tmp_path / "ck")
    ttrain.main(args + ["--steps", "2", "--ckpt-every", "2", "--ckpt-dir",
                        ck])
    resumed = ttrain.main(args + ["--steps", "3", "--resume", "--ckpt-dir",
                                  ck])
    whole = ttrain.main(args + ["--steps", "3"])
    assert resumed["start_step"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    assert resumed["model_checksum"] == whole["model_checksum"]
