"""xLSTM training in repro_torch against the JAX package (CPU, fp32,
smoke configs, numpy-seeded inputs, JAX's parameters carried over).

  (a) ``mlstm_scan_bwd_plain`` (the mLSTM backward kernel's arithmetic
      step by step) against ``jax.vjp`` of JAX's ``ref.mlstm_chunked``,
      all five gradients, the final state's cotangent 0 (relative L2 of
      each gradient, ``BWD_TOL``), and against torch autograd through the
      port's ``ref.mlstm_chunked(acc_dtype=torch.float64)``
      (``BWD64_TOL``): a multiple of the chunk, a ragged tail, S below the
      chunk, dk != dv, and large gates (i~ up to +-30, f~ down to -10);
  (b) ``MLSTMScanFn`` on CPU tensors (the wrappers' plain versions)
      against torch autograd through the port's ``ref.mlstm_chunked``,
      in fp32 and bf16 (``BWD_TOL``; bf16 ``BF16_TOL``: both round the
      same bf16 inputs' gradients once); a gradient reaching the final
      state raises; the kernel dispatch goes through it only when a
      gradient is wanted; the wrapper runs its plain version on the CPU
      only;
  (c) ``mlstm_block``'s and ``slstm_block``'s output and the gradients
      of their parameters and input under one cotangent against
      ``jax.vjp`` of JAX's, at impl "kernel" and "reference" (``TOL``
      relative to max(1, max |want|); gradients ``LEAF_TOL`` of each
      leaf's largest magnitude);
  (d) xlstm-125m smoke: ``loss_fn`` and every leaf's gradient against
      ``jax.value_and_grad`` at remat "none" and "full" (loss ``RTOL``,
      gradients ``LEAF_TOL``), and two AdamW train steps against JAX's
      ``build_train_step`` on a (1, 1) mesh of Auto axes (loss, grad norm,
      parameters and moments); the config checks refuse
      ``overlap="backward"`` and pipeline stages with JAX's messages;
  (e) the HetSeq invariant: capacities 2,1,1,0 through
      ``simulate_workers`` and ``accumulate_grads`` give the
      single-process loss and gradient over the real rows;
  (f) ``overlap="buckets"`` bitwise the monolithic step at fp32 and clip
      0, ``weighting="canonical"`` within the fp32 tolerances of it; two
      gloo ranks (``hierarchical``, int8, capacities 2,1, one step)
      against one process's step over the union of the real rows, to
      ``test_torch_dist_train.py``'s int8 limits on the loss and grad
      norm, the first moment within one int8 code an element;
  (g) the train driver trains xlstm smoke on the CPU, and its resume
      from a checkpoint is bitwise the uninterrupted run.

The smoke model's sequence (40 tokens) is below the scan's chunk of 256,
so (a) and (b) carry the multi-chunk cases. The JAX sides are computed
once, in cached helpers.
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
from repro_torch.kernels.mlstm_scan import mlstm_scan as tmk
from repro_torch.kernels.mlstm_scan import ops as tops
from repro_torch.kernels.mlstm_scan import ref as tref
from repro_torch.kernels.parity import rel_l2
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttr
from repro_torch.models import xlstm as txl
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import build_model as tbuild
from repro_torch.optim import adam as tadam

ARCH = "xlstm-125m"
# relative L2 of a gradient, about 5x the largest reading on a CPU:
# against JAX's fp32 autograd 3.3e-5 (large gates; 3.2e-6 otherwise),
# against the port's fp64 scan 1.9e-5 (large gates; 3.8e-6 otherwise;
# JAX's own fp32 autograd reads 2.2e-5 there): fp32 sums in another
# order, and at large gates a denominator that cancels
BWD_TOL = 1.5e-4
BWD64_TOL = 1e-4
BF16_TOL = 1e-2      # relative L2 of a bf16-rounded gradient
TOL = 2e-5           # outputs, relative to max(1, max |want|)
RTOL = 1e-5          # losses
GNORM_RTOL = 1e-4
LEAF_TOL = 1e-4      # of each leaf's largest magnitude
# the int8 exchange's limits (test_torch_dist_train.py's)
INT8 = {"loss": 1e-4, "grad_norm": 1e-2}
SEQ = 40
OPT = dict(lr=1e-3, warmup_steps=1, schedule="constant", total_steps=2)
GRAD_NAMES = ("dq", "dk", "dv", "di", "df")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    from repro.configs import base as jcfgs
    jc = dataclasses.replace(jcfgs.smoke_config(ARCH),
                             compute_dtype="float32", **kw)
    tc = dataclasses.replace(tcfgs.smoke_config(ARCH),
                             compute_dtype="float32", **kw)
    return jc, tc


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, (list, tuple)):
            out.update(_flat({str(i): x for i, x in enumerate(v)},
                             f"{prefix}{k}/"))
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
# (a), (b) the mLSTM backward
# --------------------------------------------------------------------------

# b, s, h, dk, dv, chunk, large gates
BWD_CASES = [
    (2, 64, 2, 32, 32, 16, False),          # a multiple of the chunk
    (2, 50, 2, 32, 32, 16, False),          # a ragged tail
    (1, 10, 2, 16, 16, 32, False),          # S below the chunk
    (1, 40, 2, 32, 16, 16, False),          # dk != dv
    (2, 64, 2, 32, 32, 16, True),           # i~ up to +-30, f~ to -10
]


def _bwd_inputs(seed, b, s, h, dk, dv, large):
    """q, k, v, dh ~ N(0, 1); the gates as xlstm-125m's init sets them up
    (i~ ~ N(0, 1), f~ ~ N(4.5, 1)), or large: i~ ~ U(-30, 30), f~ ~
    U(-10, 6)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, k, v = f(b, s, h, dk), f(b, s, h, dk), f(b, s, h, dv)
    if large:
        i_pre = rng.uniform(-30, 30, (b, s, h)).astype(np.float32)
        f_pre = rng.uniform(-10, 6, (b, s, h)).astype(np.float32)
    else:
        i_pre, f_pre = f(b, s, h), f(b, s, h) + 4.5
    return q, k, v, i_pre, f_pre, f(b, s, h, dv)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk,large", BWD_CASES)
def test_mlstm_bwd_plain_matches_jax_vjp_and_fp64(b, s, h, dk, dv, chunk,
                                                  large):
    import jax
    import jax.numpy as jnp
    from repro.kernels.mlstm_scan import ref as jref
    arrays = _bwd_inputs(b * s + dk + dv, b, s, h, dk, dv, large)

    def f(*args):
        y, _ = jref.mlstm_chunked(*args, chunk_size=chunk)
        return y

    want = jax.jit(lambda c, *args: jax.vjp(f, *args)[1](c))(
        jnp.asarray(arrays[5]), *[jnp.asarray(a) for a in arrays[:5]])
    t = [torch.from_numpy(a) for a in arrays]
    got = tmk.mlstm_scan_bwd_plain(*t, chunk_size=chunk)
    assert [g.shape for g in got] == [a.shape for a in arrays[:5]]
    assert all(g.dtype == torch.float32 for g in got)
    for name, gv, wv in zip(GRAD_NAMES, got, want):
        err = rel_l2(gv, torch.from_numpy(np.array(wv)))
        assert err <= BWD_TOL, (name, err)
    # against autograd through the fp64 scan
    ins = [x.double().requires_grad_(True) for x in t[:5]]
    y, _ = tref.mlstm_chunked(*ins, chunk_size=chunk,
                              acc_dtype=torch.float64)
    want64 = torch.autograd.grad(y, ins, t[5].double())
    for name, gv, wv in zip(GRAD_NAMES, got, want64):
        err = rel_l2(gv, wv)
        assert err <= BWD64_TOL, (name, err)


def test_mlstm_chunked_fp64_option_keeps_the_fp32_default_bitwise():
    t = [torch.from_numpy(a) for a in _bwd_inputs(3, 2, 50, 2, 32, 32,
                                                  False)[:5]]
    h32, st32 = tref.mlstm_chunked(*t, chunk_size=16)
    h_again, st_again = tref.mlstm_chunked(*t, chunk_size=16,
                                           acc_dtype=torch.float32)
    assert torch.equal(h32, h_again)
    assert all(torch.equal(a, b) for a, b in zip(st32, st_again))
    h64, st64 = tref.mlstm_chunked(*t, chunk_size=16,
                                   acc_dtype=torch.float64)
    assert h64.dtype == torch.float32
    assert all(x.dtype == torch.float32 for x in st64)
    assert rel_l2(h32, h64) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[3]])
def test_mlstm_scan_fn_on_cpu_matches_autograd(case, dtype):
    b, s, h, dk, dv, chunk, large = case
    arrays = [torch.from_numpy(a) for a in _bwd_inputs(7, b, s, h, dk, dv,
                                                       large)]
    q, k, v, i_pre, f_pre, dh = arrays
    q, k, v, dh = (x.to(dtype) for x in (q, k, v, dh))

    def leaves():
        return [x.clone().requires_grad_(True) for x in (q, k, v, i_pre,
                                                          f_pre)]

    ins = leaves()
    tmk.mlstm_scan_bwd_cuda.launches = 0
    y, C, n, m = tmk.MLSTMScanFn.apply(*ins, chunk)
    assert y.dtype == dtype and C.dtype == n.dtype == torch.float32
    assert not m.requires_grad
    got = torch.autograd.grad(y, ins, dh)
    assert tmk.mlstm_scan_bwd_cuda.launches == 0     # the CPU plain version
    ref_ins = leaves()
    y_ref, _ = tref.mlstm_chunked(*ref_ins, chunk_size=chunk)
    want = torch.autograd.grad(y_ref, ref_ins, dh)
    assert torch.equal(y, y_ref)
    tol = BWD_TOL if dtype == torch.float32 else BF16_TOL
    for name, gv, wv in zip(GRAD_NAMES, got, want):
        assert gv.dtype == wv.dtype, name
        assert rel_l2(gv, wv) <= tol, (name, rel_l2(gv, wv))
    # the final state takes no gradient: reaching it raises
    ins = leaves()
    y, C, n, _ = tmk.MLSTMScanFn.apply(*ins, chunk)
    with pytest.raises(RuntimeError, match="final state"):
        torch.autograd.grad(y.float().sum() + C.sum(), ins)


def test_kernel_dispatch_differentiates_only_when_asked(monkeypatch):
    q, k, v, i_pre, f_pre, _ = (torch.from_numpy(a) for a in _bwd_inputs(
        3, 1, 20, 2, 16, 16, False))
    calls = []
    real = tmk.MLSTMScanFn.apply
    monkeypatch.setattr(tops.MLSTMScanFn, "apply",
                        lambda *a: calls.append(1) or real(*a))
    y0, st0 = tops.mlstm_scan(q, k, v, i_pre, f_pre, chunk_size=16,
                              impl="kernel")
    assert not calls
    qg = q.clone().requires_grad_(True)
    y1, st1 = tops.mlstm_scan(qg, k, v, i_pre, f_pre, chunk_size=16,
                              impl="kernel")
    assert calls and y1.requires_grad and torch.equal(y1.detach(), y0)
    assert all(torch.equal(a.detach(), b) for a, b in zip(st1, st0))
    with torch.no_grad():
        tops.mlstm_scan(qg, k, v, i_pre, f_pre, chunk_size=16, impl="kernel")
    assert len(calls) == 1


def test_mlstm_bwd_wrapper_runs_the_plain_version_on_cpu_only():
    """CPU tensors take the plain version and count no launch; tensors on
    any other device than the CPU or a card raise (no fallback)."""
    args = [torch.from_numpy(a) for a in _bwd_inputs(4, 1, 20, 2, 64, 64,
                                                     False)]
    tmk.mlstm_scan_bwd_cuda.launches = 0
    got = tmk.mlstm_scan_bwd_cuda(*args, chunk_size=16)
    want = tmk.mlstm_scan_bwd_plain(*args, chunk_size=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tmk.mlstm_scan_bwd_cuda.launches == 0
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tmk.mlstm_scan_bwd_cuda(*[t.to("meta") for t in args])
    # the scratch: per chunk 11 records of q rows, the carry, a carry
    # part a 64 x 64 state tile, two (dk, dv) states, two n, X (q, dk)
    assert tmk.bwd_scratch_floats(5, 1024, 4, 384, 384, 256) == 80 * (
        11 * 256 + 1 + 36 + 2 * 384 * 384 + 2 * 384 + 256 * 384)


# --------------------------------------------------------------------------
# (c) the mLSTM and sLSTM blocks under autograd
# --------------------------------------------------------------------------


def _block_params(init, jc, seed):
    """JAX's init shapes; the zero and one inits (biases, skip, norms)
    redrawn with numpy so they carry information, the rest nudged."""
    import jax
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(np.asarray, init(jc, jax.random.PRNGKey(0)))
    out = {}
    for k, v in jp.items():
        r = rng.standard_normal(v.shape).astype(np.float32)
        if k in ("conv_b", "b_if", "b_ifzo"):
            out[k] = v + r
        elif k in ("skip", "out_norm"):
            out[k] = 1.0 + 0.1 * r
        else:
            out[k] = v + 0.1 * r * float(np.abs(v).mean())
    return out


@pytest.mark.parametrize("kind,impl", [("mlstm", "kernel"),
                                       ("mlstm", "reference"),
                                       ("slstm", "kernel"),
                                       ("slstm", "reference")])
def test_block_grads_match_jax_vjp(kind, impl):
    import jax
    import jax.numpy as jnp
    from repro.models import blocks as jblocks
    from repro.models import xlstm as jxl
    jc, tc = _cfgs()
    tc = dataclasses.replace(tc, attention_impl=impl)
    jinit, jblock = {"mlstm": (jxl.init_mlstm_block, jxl.mlstm_block),
                     "slstm": (jxl.init_slstm_block, jxl.slstm_block)}[kind]
    tblock = {"mlstm": txl.mlstm_block, "slstm": txl.slstm_block}[kind]
    jp = _block_params(jinit, jc, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, SEQ, jc.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jfn(p, xx, c):
        out, vjp = jax.vjp(lambda pp, z: jblock(pp, z, jc, jblocks.LOCAL_CTX),
                           p, xx)
        return out, vjp(c)

    jy, (jgp, jgx) = jax.jit(jfn)({k: jnp.asarray(v) for k, v in jp.items()},
                                  jnp.asarray(x), jnp.asarray(cot))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tblock(tp, tx, tc)
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


def test_slstm_cell_splits_a_tied_normalizer_as_jax_does():
    """``n_new`` at exactly 1e-6: JAX's ``jnp.maximum`` gives each side
    half the gradient, and so does the port (``torch.clamp`` would give
    n_new all of it). f~ = 30 against m = 0 makes f_g = exp(0) = 1 and
    i~ = -1e4 makes i_g = 0, so n_new is the carried n, 1e-6."""
    import jax
    import jax.numpy as jnp
    from repro.models import xlstm as jxl
    b, d, nh = 2, 4, 2
    r = np.zeros((nh, d // nh, 4 * (d // nh)), np.float32)
    gx = np.zeros((b, 4 * d), np.float32)
    gx[:, :d] = -1e4                           # i~
    gx[:, d:2 * d] = 30.0                      # f~
    c = np.full((b, d), 0.5, np.float32)
    n = np.full((b, d), 1e-6, np.float32)
    zeros = np.zeros((b, d), np.float32)

    def jh(nn):
        carry = (jnp.asarray(c), nn, jnp.asarray(zeros), jnp.asarray(zeros))
        return jxl._slstm_cell(carry, jnp.asarray(gx), jnp.asarray(r),
                               nh)[1].sum()

    want = np.asarray(jax.grad(jh)(jnp.asarray(n)))
    tn = torch.from_numpy(n).requires_grad_(True)
    carry = (torch.from_numpy(c), tn, torch.from_numpy(zeros),
             torch.from_numpy(zeros))
    _, h = txl._slstm_cell(carry, torch.from_numpy(gx), torch.from_numpy(r))
    got = torch.autograd.grad(h.sum(), tn)[0].numpy()
    # h = sigmoid(0) c / max(n, 1e-6): half of -0.5 c / n^2 goes to n
    np.testing.assert_allclose(want, -0.5 * c / n ** 2 / 2, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# --------------------------------------------------------------------------
# (d) loss, gradients and train steps against JAX
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_side():
    """(JAX parameters at seed 0, the batch, JAX's objective, weight and
    gradient), jitted, once."""
    import jax
    from repro.models.blocks import LOCAL_CTX
    from repro.models.model import build_model as jbuild
    jc, _ = _cfgs()
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
def test_loss_and_grads_match_jax(impl, remat):
    _, tc = _cfgs(remat=remat)
    tc = dataclasses.replace(tc, attention_impl=impl)
    assert ttr.stack_plan(tc) == "xlstm"
    jparams, batch, jo, jw, jg = _jax_side()
    model = tbuild(tc, "cpu")
    params = params_from_jax(jparams, tc, "cpu")
    (to, tw), tg = value_and_grad(model.loss_fn, params, _tb(batch),
                                  ce_impl=impl, label_smoothing=0.1)
    np.testing.assert_allclose(float(to), jo, rtol=RTOL)
    assert float(tw) == jw == float(batch["weights"].sum())
    _assert_trees_close(tg, jg, "xlstm grads")


def _train_cfgs(accum=2, **het):
    from repro.configs import base as jcfgs
    jc, tc = _cfgs()
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


def test_two_train_steps_match_jax():
    import jax
    from jax.sharding import AxisType
    from repro import compat
    from repro.launch import steps as jsteps
    from repro.models.model import build_model as jbuild
    jc, tc, tj, tt = _train_cfgs()
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
    # the moments element by element; the parameters by each leaf's
    # relative L2: an element whose first gradient lies within a few eps
    # (1e-8) of 0 moves by lr g / (|g| + eps), which turns the gradient's
    # fp32 noise into a visible share of lr (one w_q element reads 5% of
    # its update here, 1.4e-4 of the leaf's largest value)
    _assert_trees_close(state.opt.m, jstate.opt.m, "m")
    _assert_trees_close(state.opt.v, jstate.opt.v, "v")
    import jax
    got = _flat(params_to_numpy(state.params))
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    assert set(got) == set(want)
    for k, w in want.items():
        rel = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
        assert rel <= LEAF_TOL, (k, rel)


@pytest.mark.parametrize("het", [
    dict(overlap="backward", bucket_mb=0.05,
         grad_reduction="bucketed_allreduce"),
    dict(pipeline_stages=2, accum_steps=2)])
def test_staged_modes_are_refused_as_jax_refuses_them(het):
    import jax
    from repro.configs import base as jcfgs
    from repro.launch import steps as jsteps
    from repro.models.model import build_model as jbuild
    jc, tc = _cfgs(scan_layers=False)
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
# (e) the HetSeq invariant
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
# (f) the step modes: overlap, canonical, two ranks with int8
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
    # archs' canonical step
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
    # the first moment (the gradient scaled) over the whole tree, within
    # the relative L2 that moving every element by one int8 code (1/127
    # of its 256-element stream row's largest value) would give: 4.0%
    # here, the reading 1.2% (stochastic rounding moves most elements by
    # less; xlstm's rows are heavy-tailed, max/rms ~4)
    from repro_torch.core import buckets as bkt
    got, want = _flat(ranks[0]["m"]), _flat(params_to_numpy(state.opt.m))
    g = np.concatenate([got[k].reshape(-1) for k in sorted(want)])
    w = np.concatenate([want[k].reshape(-1) for k in sorted(want)])
    stream = torch.cat([p.reshape(-1) for _, ps in bkt.stream_leaves(
        state.opt.m) for p in ps]).double()
    rows = torch.nn.functional.pad(stream, (0, -stream.numel() % 256))
    code = rows.reshape(-1, 256).abs().amax(dim=1) / 127
    one_code = float(torch.sqrt(256 * (code ** 2).sum()) / stream.norm())
    assert np.linalg.norm(g - w) <= one_code * np.linalg.norm(w)


# --------------------------------------------------------------------------
# (g) the driver
# --------------------------------------------------------------------------


def test_train_driver_trains_xlstm_smoke():
    """``python -m repro_torch.launch.train --arch xlstm-125m --smoke
    --device cpu``: the loss falls, every step finite."""
    from repro_torch.launch import train as ttrain
    out = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "4", "--global-batch", "8", "--seq-len",
                       "32", "--accum", "2", "--lr", "3e-3", "--warmup",
                       "1", "--schedule", "constant", "--log-every", "4"])
    assert out["steps"] == 4 and all(np.isfinite(out["losses"]))
    assert out["last_loss"] < out["first_loss"]


def test_driver_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """A checkpoint of xlstm smoke at step 2 (the mLSTM and sLSTM stacks
    in the JAX layout), resumed to step 3, gives the uninterrupted run's
    loss and parameters bit for bit."""
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
