"""repro_torch's xLSTM serving path (xlstm-125m) against the JAX package
on the CPU, fp32 throughout, inputs made with numpy from a seed:

* the mLSTM plain versions (``mlstm_sequential``, ``mlstm_chunked``,
  ``mlstm_decode_step``) against JAX's ``ref.py`` on the shapes of
  ``tests/test_kernels.py`` (a ragged tail, dk != dv) plus S shorter
  than the chunk (``SCAN_TOL`` relative to the largest |want|: the same
  fp32 arithmetic with another exp and log1p), and ``mlstm_chunked``
  against ``mlstm_scan_pallas`` in interpret mode (``PALLAS_TOL``
  relative to the largest |want|; the JAX test holds the kernel to 2e-3
  absolute on outputs of up to ~30);
* the CUDA wrapper's CPU path and the dispatch;
* ``mlstm_block``, ``slstm_block`` (with their states) and three decode
  steps of each on the smoke widths, with the zero/one inits replaced by
  random values (``TOL`` relative to the largest |want|);
* the smoke model: ``prefill`` of 300 tokens (a full chunk of 256 and a
  ragged tail) into a cache of 304, every cache leaf, two ``decode``
  steps, ``logits_fn``, and ``static_generate`` tokens identical to
  JAX's under both scan impls, JAX on a (1, 1) mesh of Auto axes;
* the config field by field, the parameter tree and count (173,008,944
  at full size), the ``params_from_jax``/``params_to_numpy`` round trip,
  that ``loss_fn`` and ``build_train_step`` take the config, and what the
  port refuses (the paged engine, widths the kernel does not take).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import base as jcfgs
from repro.kernels.mlstm_scan import ref as jref
from repro.kernels.mlstm_scan.mlstm_scan import mlstm_scan_pallas
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import blocks as jblocks
from repro.models import model as jmodel_mod
from repro.models import xlstm as jxl
from repro.models.kvcache import PagedLayout as JLayout
from repro.models.model import build_model as jbuild
from repro_torch.configs import base as tcfgs
from repro_torch.kernels.mlstm_scan import ops as tops
from repro_torch.kernels.mlstm_scan import ref as tref
from repro_torch.kernels.mlstm_scan.mlstm_scan import mlstm_scan_cuda
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttr
from repro_torch.models import xlstm as txl
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import build_model as tbuild

ARCH = "xlstm-125m"
# each relative to max(1, max |want|), about 5x the largest reading on
# this CPU (1.9e-5, 1.2e-5, 2.3e-6): XLA's and torch's exp and log1p
# differ by an ulp or two, and the sequential scan compounds that over
# 128 steps of the state
SCAN_TOL = 1e-4      # the plain versions against JAX's ref.py
PALLAS_TOL = 1e-4    # mlstm_chunked against interpret-mode Pallas
TOL = 2e-5           # the blocks and the smoke model
FULL_PARAMS = 173_008_944

SCAN_SHAPES = [      # b, s, h, dk, dv, chunk
    (2, 128, 4, 32, 32, 64),
    (1, 100, 2, 16, 24, 32),                # ragged tail, dk != dv
    (2, 64, 3, 8, 8, 16),
    (2, 20, 2, 16, 8, 64),                  # S shorter than the chunk
]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _close(got, want, tol):
    """Within ``tol`` of max(1, max |want|), absolute."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _scan_inputs(seed, b, s, h, dk, dv):
    """tests/test_kernels.py's distributions: q, k, v ~ N(0, 1), i~ ~ 2N,
    f~ ~ 2N + 2."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (f(b, s, h, dk), f(b, s, h, dk), f(b, s, h, dv),
            f(b, s, h) * 2, f(b, s, h) * 2 + 2)


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


# --------------------------------------------------------------------------
# the mLSTM plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,dk,dv,chunk", SCAN_SHAPES)
def test_mlstm_plain_versions_match_jax(b, s, h, dk, dv, chunk):
    arrays = _scan_inputs(6, b, s, h, dk, dv)
    j, t = _both(arrays)
    for jfn, tfn, kw in ((jref.mlstm_sequential, tref.mlstm_sequential, {}),
                         (jref.mlstm_chunked, tref.mlstm_chunked,
                          {"chunk_size": chunk})):
        jy, jst = jfn(*j, **kw)
        ty, tst = tfn(*t, **kw)
        _close(ty, jy, SCAN_TOL)
        for a, w in zip(tst, jst):
            assert a.dtype == torch.float32
            _close(a, w, SCAN_TOL)
    # a decode step from the state after the first S - 1 tokens
    jy, jst = jref.mlstm_sequential(*(a[:, :-1] for a in j))
    ty, tst = tref.mlstm_sequential(*(a[:, :-1] for a in t))
    jh, jst = jref.mlstm_decode_step(jst, *(a[:, -1] for a in j))
    th, tst = tref.mlstm_decode_step(tst, *(a[:, -1] for a in t))
    _close(th, jh, SCAN_TOL)
    for a, w in zip(tst, jst):
        _close(a, w, SCAN_TOL)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", SCAN_SHAPES)
def test_mlstm_chunked_matches_pallas_interpret(b, s, h, dk, dv, chunk):
    arrays = _scan_inputs(8, b, s, h, dk, dv)
    j, t = _both(arrays)
    jy, jst = mlstm_scan_pallas(*j, chunk_size=chunk, interpret=True)
    ty, tst = tref.mlstm_chunked(*t, chunk_size=chunk)
    _close(ty, jy, PALLAS_TOL)
    for a, w in zip(tst, jst):
        _close(a, w, PALLAS_TOL)


def test_mlstm_chunked_carries_an_initial_state_like_jax():
    arrays = _scan_inputs(9, 1, 50, 2, 16, 8)
    rng = np.random.default_rng(10)
    st = (rng.standard_normal((1, 2, 16, 8)).astype(np.float32),
          rng.standard_normal((1, 2, 16)).astype(np.float32),
          rng.standard_normal((1, 2)).astype(np.float32))
    j, t = _both(arrays)
    jst0, tst0 = _both(st)
    jy, jst = jref.mlstm_chunked(*j, chunk_size=16,
                                 initial_state=tuple(jst0))
    ty, tst = tref.mlstm_chunked(*t, chunk_size=16,
                                 initial_state=tuple(tst0))
    _close(ty, jy, SCAN_TOL)
    for a, w in zip(tst, jst):
        _close(a, w, SCAN_TOL)


def test_mlstm_kernel_wrapper_and_dispatch_run_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is ``ref.mlstm_chunked`` and counts no
    launch; the dispatch's "kernel" starts from zero state only."""
    arrays = _scan_inputs(11, 2, 100, 2, 64, 64)
    _, t = _both(arrays)
    t[0], t[1], t[2] = t[0].bfloat16(), t[1].bfloat16(), t[2].bfloat16()
    mlstm_scan_cuda.launches = 0
    got = mlstm_scan_cuda(*t, chunk_size=32)
    want = tref.mlstm_chunked(*t, chunk_size=32)
    via = tops.mlstm_scan(*t, chunk_size=32, impl="kernel")
    for a, b_, c in zip((got[0],) + got[1], (want[0],) + want[1],
                        (via[0],) + via[1]):
        assert a.dtype == b_.dtype and torch.equal(a, b_)
        assert torch.equal(c, b_)
    assert got[0].dtype == torch.bfloat16
    assert all(x.dtype == torch.float32 for x in got[1])
    assert mlstm_scan_cuda.launches == 0
    seq = tops.mlstm_scan(*t, impl="sequential")
    ref_seq = tref.mlstm_sequential(*t)
    assert torch.equal(seq[0], ref_seq[0])
    with pytest.raises(NotImplementedError, match="zero state"):
        tops.mlstm_scan(*t, impl="kernel",
                        initial_state=tref.init_state(2, 2, 64, 64))
    with pytest.raises(ValueError, match="unknown mlstm impl"):
        tops.mlstm_scan(*t, impl="pallas")


# --------------------------------------------------------------------------
# the mLSTM and sLSTM blocks
# --------------------------------------------------------------------------

def _cfgs(impl="reference"):
    jc = dataclasses.replace(jcfgs.smoke_config(ARCH),
                             compute_dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config(ARCH),
                             compute_dtype="float32", attention_impl=impl)
    return jc, tc


def _block_params(init, jc, seed):
    """JAX's init shapes; the zero and one inits (biases, skip, norms)
    redrawn with numpy so they carry information, the rest nudged."""
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
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


@pytest.mark.parametrize("kind,impl", [("mlstm", "reference"),
                                       ("mlstm", "kernel"),
                                       ("slstm", "reference")])
def test_blocks_and_decode_steps_match_jax(kind, impl):
    jc, tc = _cfgs(impl)
    jinit, jblock, jdec = {
        "mlstm": (jxl.init_mlstm_block, jxl.mlstm_block,
                  jxl.mlstm_block_decode),
        "slstm": (jxl.init_slstm_block, jxl.slstm_block,
                  jxl.slstm_block_decode)}[kind]
    tblock, tdec = {"mlstm": (txl.mlstm_block, txl.mlstm_block_decode),
                    "slstm": (txl.slstm_block, txl.slstm_block_decode)}[kind]
    jp, tp = _block_params(jinit, jc, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, jc.d_model)).astype(np.float32)
    jy, jstate = jblock(jp, jnp.asarray(x), jc, jblocks.LOCAL_CTX,
                        return_state=True)
    ty, tstate = tblock(tp, torch.from_numpy(x), tc, return_state=True)
    _close(ty, jy, TOL)
    leaves = lambda st: [st[0], *st[1]]
    for a, w in zip(leaves(tstate), leaves(jstate)):
        _close(a, w, TOL)
    for _ in range(3):
        xt = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
        jy, jstate = jdec(jp, jnp.asarray(xt), jc, jblocks.LOCAL_CTX,
                          jstate)
        ty, tstate = tdec(tp, torch.from_numpy(xt), tc, tstate)
        _close(ty, jy, TOL)
        for a, w in zip(leaves(tstate), leaves(jstate)):
            _close(a, w, TOL)
    init = {"mlstm": (txl.init_mlstm_state, jxl.init_mlstm_state),
            "slstm": (txl.init_slstm_state, jxl.init_slstm_state)}[kind]
    for a, w in zip(leaves(init[0](tc, 2, "cpu")), leaves(init[1](jc, 2))):
        assert a.shape == w.shape and np.array_equal(_np(a), _np(w))


def test_headwise_rmsnorm_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    s = rng.standard_normal((48,)).astype(np.float32)
    _close(txl._headwise_rmsnorm(torch.from_numpy(x), torch.from_numpy(s)),
           jxl._headwise_rmsnorm(jnp.asarray(x), jnp.asarray(s)), 1e-6)


# --------------------------------------------------------------------------
# the xlstm smoke model, against JAX
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    jc, _ = _cfgs()
    model = jbuild(jc)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    params = jsteps.init_params_sharded(model, mesh, jax.random.PRNGKey(0))
    return jc, model, params, mesh


def _torch_side(jparams, impl):
    _, tc = _cfgs(impl)
    return tc, tbuild(tc, "cpu"), params_from_jax(
        jax.tree.map(np.asarray, jparams), tc, "cpu")


def _jax_leaves(cache):
    """The JAX nested cache in the port's flat names."""
    (mconv, (mc, mn, mm)), (sconv, scell) = cache["mlstm"], cache["slstm"]
    return dict(zip(ttr.XLSTM_CACHE["mlstm"] + ttr.XLSTM_CACHE["slstm"],
                    (mconv, mc, mn, mm, sconv, *scell)))


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_prefill_cache_and_decode_match_jax(jax_side, impl):
    """Prefill of 300 tokens (a full chunk of 256 and a ragged tail) into
    a cache of 304 positions, then two decode steps: logits and every
    cache leaf agree."""
    jc, jmodel, jparams, _ = jax_side
    _, tmodel, tparams = _torch_side(jparams, impl)
    rng = np.random.default_rng(1)
    x = rng.integers(0, jc.vocab_size, (2, 302)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(x[:, :300]),
                                max_len=304)
    tl, tcache = tmodel.prefill(tparams, torch.from_numpy(x[:, :300]),
                                max_len=304)
    _close(tl, jl, TOL)
    want = _jax_leaves(jcache)
    assert list(tcache) == list(want)
    for name, w in want.items():
        assert tcache[name].dtype == torch.float32, name
        _close(tcache[name], w, TOL)
    for pos in (300, 301):
        jl, jcache = jmodel.decode(jparams, jnp.asarray(x[:, pos]), jcache,
                                   jnp.int32(pos))
        tl, tcache = tmodel.decode(tparams, torch.from_numpy(x[:, pos]),
                                   tcache, pos)
        _close(tl, jl, TOL)
        for name, w in _jax_leaves(jcache).items():
            _close(tcache[name], w, TOL)
    zero = tmodel.init_cache(2, 304)
    jzero = _jax_leaves(jmodel.init_cache(2, 304))
    assert {k: (v.shape, v.dtype) for k, v in zero.items()} == {
        k: (v.shape, v.dtype) for k, v in tcache.items()}
    for name, w in jzero.items():
        assert np.array_equal(_np(zero[name]), _np(w)), name


def test_logits_fn_matches_jax(jax_side):
    jc, jmodel, jparams, _ = jax_side
    _, tmodel, tparams = _torch_side(jparams, "kernel")
    x = np.random.default_rng(2).integers(0, jc.vocab_size,
                                          (2, 37)).astype(np.int32)
    _close(tmodel.logits_fn(tparams, torch.from_numpy(x)),
           jmodel.logits_fn(jparams, jnp.asarray(x)), TOL)


@pytest.fixture(scope="module")
def jax_tokens(jax_side):
    jc, jmodel, jparams, mesh = jax_side
    prompts = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 300)).astype(np.int32)
    with compat.set_mesh(mesh):
        want = jserve.static_generate(jmodel, jparams, mesh, prompts, 6)
    return prompts, np.asarray(want)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_static_generate_tokens_match_jax(jax_side, jax_tokens, impl):
    """Prompt 300 (a ragged tail at chunk 256), 6 tokens, greedy: the
    same token ids as JAX's ``static_generate`` on a (1, 1) Auto mesh."""
    _, _, jparams, _ = jax_side
    prompts, want = jax_tokens
    _, tmodel, tparams = _torch_side(jparams, impl)
    got = tserve.static_generate(tmodel, tparams, prompts, 6)
    assert got.shape == (2, 6) and np.array_equal(got, want)


# --------------------------------------------------------------------------
# config, parameters, conversion, refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["smoke", "full"])
def test_config_matches_jax_field_by_field(which):
    get = {"smoke": "smoke_config", "full": "resolve"}[which]
    jc, tc = getattr(jcfgs, get)(ARCH), getattr(tcfgs, get)(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert ([f.name for f in dataclasses.fields(tc.xlstm)]
            == [f.name for f in dataclasses.fields(jc.xlstm)])
    assert tc.param_count() == jmodel_mod.count_params_analytic(jc)
    assert ttr.stack_plan(tc) == "xlstm"
    if which == "full":
        assert tc.param_count() == FULL_PARAMS
        assert txl.mlstm_dims(tc) == (1536, 4, 384)


def test_param_tree_shapes_and_count_match_jax():
    cfg, jcfg = tcfgs.smoke_config(ARCH), jcfgs.smoke_config(ARCH)
    jp = jax.eval_shape(jbuild(jcfg).init_params, jax.random.PRNGKey(0))
    tp = ttr.init_params(cfg, 0, "cpu")
    assert sorted(tp) == sorted(jp)
    pairs = cfg.num_layers // 2
    for stack in ("mlstm_layers", "slstm_layers"):
        assert len(tp[stack]) == pairs
        flat_j = dict(jax.tree_util.tree_flatten_with_path(jp[stack])[0])
        for path, leaf in flat_j.items():
            node = tp[stack][0]
            for key in path:
                node = node[key.key]
            assert (pairs,) + tuple(node.shape) == leaf.shape, path
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    n = sum(t.numel() for t in ttr.tree_leaves(tp))
    assert n == cfg.param_count() == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    blk = tp["mlstm_layers"][0]["blk"]
    h = cfg.xlstm.num_heads
    assert torch.equal(blk["b_if"][h:], torch.linspace(3.0, 6.0, h))
    assert not blk["b_if"][:h].any() and bool((blk["skip"] == 1).all())
    sb = tp["slstm_layers"][0]["blk"]
    d = cfg.d_model
    assert torch.equal(sb["b_ifzo"][d:2 * d], torch.linspace(3.0, 6.0, d))


def test_params_round_trip_through_the_jax_layout(jax_side):
    _, _, jparams, _ = jax_side
    tree = jax.tree.map(np.asarray, jparams)
    _, tc = _cfgs()
    tp = params_from_jax(tree, tc, "cpu")
    assert "layers" not in tp and len(tp["mlstm_layers"]) == 2
    assert set(tp["slstm_layers"][1]) == {"ln", "blk"}
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert x.shape == y.shape and np.array_equal(x, y)
    del tree["slstm_layers"]
    with pytest.raises(ValueError, match="slstm_layers"):
        params_from_jax(tree, tc, "cpu")
    cut = dataclasses.replace(tc, num_layers=2)
    with pytest.raises(ValueError, match="does not lead with 1"):
        params_from_jax(jax.tree.map(np.asarray, jparams), cut, "cpu")


def test_loss_fn_and_train_step_accept_xlstm():
    """xLSTM trains (tests/test_torch_xlstm_train.py holds it against
    JAX): ``loss_fn`` and ``build_train_step`` take the smoke config,
    which passes the serving check as before."""
    from repro_torch.launch import steps as tsteps
    _, tc = _cfgs()
    model = tbuild(tc, "cpu")
    params = model.init_params(0)
    batch = {"inputs": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32),
             "weights": torch.ones((1, 4))}
    o, w, _ = model.loss_fn(params, batch)
    assert torch.isfinite(o) and float(w) == 4.0
    tcfg = tcfgs.TrainConfig(model=tc, shape=tcfgs.ShapeConfig(
        "t", 4, 1, "train"), optimizer=tcfgs.OptimizerConfig(lr=1e-3))
    state = tsteps.init_train_state(model, tcfg)
    state, met = tsteps.build_train_step(model, tcfg)(state, batch)
    assert np.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0
    ttr.check_supported(tc)
    ttr.check_supported(tc, serving=True)


def test_check_servable_on_the_card_names_kernel_widths():
    full = dataclasses.replace(tcfgs.resolve(ARCH), attention_impl="kernel")
    ttr.check_servable(full, "cuda", paged=False)
    for heads, dk in ((16, 96), (2, 768)):     # not a multiple of 64; > 512
        odd = dataclasses.replace(full, xlstm=dataclasses.replace(
            full.xlstm, num_heads=heads))
        assert txl.mlstm_dims(odd)[2] == dk
        with pytest.raises(ValueError, match=f"mLSTM kernel.*got {dk}"):
            ttr.check_servable(odd, "cuda", paged=False)
        ttr.check_servable(odd, "cpu", paged=False)
    ttr.check_servable(dataclasses.replace(odd, attention_impl="reference"),
                       "cuda", paged=False)


def test_paged_engine_refuses_xlstm_as_jax_does(jax_side):
    """The serve CLI (paged engine) refuses xLSTM with the JAX package's
    message; the static path serves it."""
    _, jmodel, _, _ = jax_side
    with pytest.raises(ValueError, match="uniform attention stack only") \
            as jerr:
        jmodel.init_paged_cache(JLayout(block_size=4, num_blocks=8,
                                        max_blocks_per_seq=4))
    with pytest.raises(ValueError, match="uniform attention stack only") \
            as terr:
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert str(terr.value) == str(jerr.value)
