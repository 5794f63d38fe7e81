"""repro_torch's Mamba2 hybrid (zamba2) serving path against the JAX
package on the CPU, fp32 throughout, inputs made with numpy from a seed:

* the SSD plain versions (``ssd_sequential``, ``ssd_chunked``,
  ``ssd_decode_step``) against JAX's ``ref.py`` on the shapes of
  ``tests/test_kernels.py`` (padding, groups) plus one with S shorter
  than the chunk (tolerance ``SSD_TOL`` relative to the largest |want|:
  the same fp32 arithmetic summed in another order), and ``ssd_chunked``
  against ``ssd_scan_pallas`` in interpret mode (``PALLAS_TOL``,
  absolute, the JAX test's 2e-3 tightened tenfold; outputs reach ~15
  and the errors read ≤ 5e-5);
* the CUDA wrapper's CPU path and the dispatch;
* ``mamba_block`` (with its state) and three ``mamba_decode_step``s on
  the zamba2 smoke widths, with the zero/one inits replaced by random
  values (``TOL`` relative to the largest |want|: these weights give
  outputs of ~10);
* the zamba2 smoke model: ``prefill`` logits and the whole cache, two
  ``decode`` steps, ``logits_fn``, and ``static_generate`` tokens
  identical to JAX's (prompt 40: a ragged tail at chunk 32), JAX on a
  (1, 1) mesh of Auto axes;
* the config field by field, the parameter tree and count, the
  ``params_from_jax``/``params_to_numpy`` round trip, what the port
  refuses (widths the kernels do not take, the paged engine), and that
  zamba2 and a Mamba2 stack pass the training check (their training
  against JAX is in ``tests/test_torch_zamba_train.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import base as jcfgs
from repro.kernels.ssd_scan import ref as jref
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import blocks as jblocks
from repro.models import model as jmodel_mod
from repro.models import ssm as jssm
from repro.models.kvcache import PagedLayout as JLayout
from repro.models.model import build_model as jbuild
from repro_torch.configs import base as tcfgs
from repro_torch.kernels.ssd_scan import ops as tops
from repro_torch.kernels.ssd_scan import ref as tref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_cuda
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import build_model as tbuild

ARCH = "zamba2-2.7b"
SSD_TOL = 1e-5       # relative to max(1, max |want|)
PALLAS_TOL = 2e-4    # absolute: the JAX test's 2e-3, tightened tenfold
TOL = 2e-5           # model outputs and caches, absolute (O(1) values)

SSD_SHAPES = [       # b, s, h, p, g, n, chunk
    (2, 256, 8, 32, 2, 64, 128),
    (1, 100, 4, 16, 1, 32, 64),             # padding path
    (2, 64, 6, 8, 3, 16, 32),               # groups
    (2, 20, 4, 16, 1, 16, 64),              # S shorter than the chunk
]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _close(got, want, tol, relative=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if relative else 1.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = f(b, s, h, p)
    dt = np.log1p(np.exp(f(b, s, h)))                  # softplus
    A = -np.exp(f(h) * 0.5)
    Bm, Cm = f(b, s, g, n) * 0.3, f(b, s, g, n) * 0.3
    D = f(h)
    return x, dt, A, Bm, Cm, D


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


# --------------------------------------------------------------------------
# the SSD plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_plain_versions_match_jax(b, s, h, p, g, n, chunk):
    arrays = _ssd_inputs(6, b, s, h, p, g, n)
    j, t = _both(arrays)
    for with_d in (True, False):
        jd, td = (j[5], t[5]) if with_d else (None, None)
        jy, jf = jref.ssd_sequential(*j[:5], jd)
        ty, tf = tref.ssd_sequential(*t[:5], td)
        _close(ty, jy, SSD_TOL, relative=True)
        _close(tf, jf, SSD_TOL, relative=True)
        jy, jf = jref.ssd_chunked(*j[:5], jd, chunk_size=chunk)
        ty, tf = tref.ssd_chunked(*t[:5], td, chunk_size=chunk)
        _close(ty, jy, SSD_TOL, relative=True)
        _close(tf, jf, SSD_TOL, relative=True)
        assert tf.dtype == torch.float32
    # one decode step from a random state, on the first token's inputs
    rng = np.random.default_rng(7)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    args = (st, arrays[0][:, 0], arrays[1][:, 0], arrays[2],
            arrays[3][:, 0], arrays[4][:, 0], arrays[5])
    jd, td = _both(args)
    jy, js = jref.ssd_decode_step(*jd)
    ty, ts = tref.ssd_decode_step(*td)
    _close(ty, jy, SSD_TOL, relative=True)
    _close(ts, js, SSD_TOL, relative=True)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_chunked_matches_pallas_interpret(b, s, h, p, g, n, chunk):
    arrays = _ssd_inputs(8, b, s, h, p, g, n)
    j, t = _both(arrays)
    jy, jf = ssd_scan_pallas(*j, chunk_size=chunk, interpret=True)
    ty, tf = tref.ssd_chunked(*t, chunk_size=chunk)
    _close(ty, jy, PALLAS_TOL)
    _close(tf, jf, PALLAS_TOL)


def test_ssd_chunked_carries_an_initial_state_like_jax():
    arrays = _ssd_inputs(9, 1, 50, 4, 16, 2, 16)
    st = np.random.default_rng(10).standard_normal(
        (1, 4, 16, 16)).astype(np.float32)
    j, t = _both(arrays)
    jy, jf = jref.ssd_chunked(*j, chunk_size=16,
                              initial_state=jnp.asarray(st))
    ty, tf = tref.ssd_chunked(*t, chunk_size=16,
                              initial_state=torch.from_numpy(st))
    _close(ty, jy, SSD_TOL, relative=True)
    _close(tf, jf, SSD_TOL, relative=True)


def test_ssd_kernel_wrapper_and_dispatch_run_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is ``ref.ssd_chunked`` and counts no
    launch; the dispatch's "kernel" starts from zero state only."""
    arrays = _ssd_inputs(11, 2, 100, 8, 64, 2, 64)
    _, t = _both(arrays)
    t[0], t[3], t[4] = (t[0].bfloat16(), t[3].bfloat16(),
                        t[4].bfloat16())
    ssd_scan_cuda.launches = 0
    for d in (t[5], None):
        got = ssd_scan_cuda(*t[:5], d, chunk_size=32)
        want = tref.ssd_chunked(*t[:5], d, chunk_size=32)
        via = tops.ssd_scan(*t[:5], d, chunk_size=32, impl="kernel")
        for a, b_, c in zip(got, want, via):
            assert a.dtype == b_.dtype and torch.equal(a, b_)
            assert torch.equal(c, b_)
        assert got[0].dtype == torch.bfloat16
        assert got[1].dtype == torch.float32
    assert ssd_scan_cuda.launches == 0
    for a, b_ in zip(tops.ssd_scan(*t, impl="sequential"),
                     tref.ssd_sequential(*t)):
        assert torch.equal(a, b_)
    with pytest.raises(NotImplementedError, match="zero state"):
        tops.ssd_scan(*t, impl="kernel",
                      initial_state=torch.zeros((2, 8, 64, 64)))
    with pytest.raises(ValueError, match="unknown ssd impl"):
        tops.ssd_scan(*t, impl="pallas")


# --------------------------------------------------------------------------
# the Mamba2 block
# --------------------------------------------------------------------------

def _cfgs(impl="reference"):
    jc = dataclasses.replace(jcfgs.smoke_config(ARCH),
                             compute_dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config(ARCH),
                             compute_dtype="float32", attention_impl=impl)
    return jc, tc


def _mamba_params(jc, seed):
    """JAX's init shapes; every leaf redrawn with numpy so the zero and
    one inits (conv_b, D, norm) carry information."""
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(np.asarray, jssm.init_mamba(jc, jax.random.PRNGKey(0)))
    out = {}
    for k, v in jp.items():
        r = rng.standard_normal(v.shape).astype(np.float32)
        if k in ("A_log", "in_proj", "out_proj"):
            out[k] = v + 0.1 * r
        else:
            out[k] = r * (0.1 if k in ("conv_b", "dt_bias") else 1.0)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_mamba_block_and_decode_steps_match_jax(impl):
    jc, tc = _cfgs(impl)
    jp, tp = _mamba_params(jc, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, jc.d_model)).astype(np.float32)
    jy, (jconv, jssm_st) = jssm.mamba_block(jp, jnp.asarray(x), jc,
                                            jblocks.LOCAL_CTX,
                                            return_state=True)
    ty, (tconv, tssm_st) = tssm.mamba_block(tp, torch.from_numpy(x), tc,
                                            return_state=True)
    _close(ty, jy, TOL, relative=True)
    _close(tconv, jconv, TOL, relative=True)
    _close(tssm_st, jssm_st, TOL, relative=True)
    jstate, tstate = (jconv, jssm_st), (tconv, tssm_st)
    for i in range(3):
        xt = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
        jy, jstate = jssm.mamba_decode_step(jp, jnp.asarray(xt), jc,
                                            jblocks.LOCAL_CTX, jstate)
        ty, tstate = tssm.mamba_decode_step(tp, torch.from_numpy(xt), tc,
                                            tstate)
        _close(ty, jy, TOL, relative=True)
        for a, b in zip(tstate, jstate):
            _close(a, b, TOL, relative=True)


def test_causal_conv_and_gated_norm_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    init = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for i in (None, init):
        jy, jt = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b),
                                   None if i is None else jnp.asarray(i))
        ty, tt = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b),
                                   None if i is None else torch.from_numpy(i))
        _close(ty, jy, 1e-5)
        _close(tt, jt, 0.0)
    z = rng.standard_normal((2, 9, 12)).astype(np.float32)
    _close(tblocks.rms_norm_gated(torch.from_numpy(x), torch.from_numpy(z),
                                  torch.from_numpy(b)),
           jblocks.rms_norm_gated(jnp.asarray(x), jnp.asarray(z),
                                  jnp.asarray(b)), 1e-5)


# --------------------------------------------------------------------------
# the zamba2 smoke model, against JAX
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


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_prefill_cache_and_decode_match_jax(jax_side, impl):
    """Prefill of 40 tokens (a full chunk of 32 and a ragged tail) into a
    cache of 44 positions, then two decode steps: logits and every cache
    tensor (conv, ssm, attn_k, attn_v) agree."""
    jc, jmodel, jparams, _ = jax_side
    _, tmodel, tparams = _torch_side(jparams, impl)
    rng = np.random.default_rng(1)
    x = rng.integers(0, jc.vocab_size, (2, 42)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(x[:, :40]), max_len=44)
    tl, tcache = tmodel.prefill(tparams, torch.from_numpy(x[:, :40]),
                                max_len=44)
    _close(tl, jl, TOL)
    assert sorted(tcache) == sorted(jcache) == ["attn_k", "attn_v", "conv",
                                                "ssm"]
    for name in jcache:
        _close(tcache[name], jcache[name], TOL)
    for pos in (40, 41):
        jl, jcache = jmodel.decode(jparams, jnp.asarray(x[:, pos]), jcache,
                                   jnp.int32(pos))
        tl, tcache = tmodel.decode(tparams, torch.from_numpy(x[:, pos]),
                                   tcache, pos)
        _close(tl, jl, TOL)
        for name in jcache:
            _close(tcache[name], jcache[name], TOL)
    zero = tmodel.init_cache(2, 44)
    assert {k: (v.shape, v.dtype) for k, v in zero.items()} == {
        k: (v.shape, v.dtype) for k, v in tcache.items()}
    assert all(not v.any() for v in zero.values())


def test_logits_fn_matches_jax(jax_side):
    jc, jmodel, jparams, _ = jax_side
    _, tmodel, tparams = _torch_side(jparams, "kernel")
    x = np.random.default_rng(2).integers(0, jc.vocab_size,
                                          (2, 37)).astype(np.int32)
    _close(tmodel.logits_fn(tparams, torch.from_numpy(x)),
           jmodel.logits_fn(jparams, jnp.asarray(x)), TOL)


def test_static_generate_tokens_match_jax(jax_side):
    """Prompt 40 (a ragged tail at chunk 32), 6 tokens, greedy: the same
    token ids as JAX's ``static_generate`` on a (1, 1) Auto mesh."""
    jc, jmodel, jparams, mesh = jax_side
    _, tmodel, tparams = _torch_side(jparams, "kernel")
    prompts = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 40)).astype(np.int32)
    with compat.set_mesh(mesh):
        want = jserve.static_generate(jmodel, jparams, mesh, prompts, 6)
    got = tserve.static_generate(tmodel, tparams, prompts, 6)
    assert got.shape == (2, 6) and np.array_equal(got, np.asarray(want))


# --------------------------------------------------------------------------
# config, parameters, conversion, refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["smoke", "full"])
def test_config_matches_jax_field_by_field(which):
    get = {"smoke": "smoke_config", "full": "resolve"}[which]
    jc, tc = getattr(jcfgs, get)(ARCH), getattr(tcfgs, get)(ARCH)
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert td == jd
    for sub in ("ssm", "hybrid"):
        assert ([f.name for f in dataclasses.fields(getattr(tc, sub))]
                == [f.name for f in dataclasses.fields(getattr(jc, sub))])
    assert tc.param_count() == jmodel_mod.count_params_analytic(jc)
    assert ttr.stack_plan(tc) == "zamba"


def test_param_tree_shapes_and_count_match_jax():
    cfg, jcfg = tcfgs.smoke_config(ARCH), jcfgs.smoke_config(ARCH)
    jp = jax.eval_shape(jbuild(jcfg).init_params, jax.random.PRNGKey(0))
    tp = ttr.init_params(cfg, 0, "cpu")
    assert sorted(tp) == sorted(jp)
    assert len(tp["layers"]) == cfg.num_layers
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp["layers"])[0])
    for path, leaf in flat_j.items():
        node = tp["layers"][0]
        for key in path:
            node = node[key.key]
        assert (cfg.num_layers,) + tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    flat_s = dict(jax.tree_util.tree_flatten_with_path(jp["shared_attn"])[0])
    for path, leaf in flat_s.items():
        node = tp["shared_attn"]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
    n = sum(t.numel() for t in ttr.tree_leaves(tp))
    assert n == cfg.param_count() == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    m = tp["layers"][0]["mamba"]
    a = torch.log(torch.arange(1, m["A_log"].numel() + 1).float())
    assert torch.equal(m["A_log"], a)
    dt0 = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 0.1001


def test_params_round_trip_through_the_jax_layout(jax_side):
    _, _, jparams, _ = jax_side
    tree = jax.tree.map(np.asarray, jparams)
    _, tc = _cfgs()
    tp = params_from_jax(tree, tc, "cpu")
    assert set(tp["shared_attn"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(tp["layers"][3]["mamba"]) == {
        "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
        "out_proj"}
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert x.shape == y.shape and np.array_equal(x, y)
    del tree["shared_attn"]
    with pytest.raises(ValueError, match="shared_attn"):
        params_from_jax(tree, tc, "cpu")


def test_training_zamba_and_ssm_is_refused():
    """No longer refused: the zamba and mamba plans pass
    ``check_supported`` for training and give a finite ``loss_fn`` (their
    gradients against JAX's: tests/test_torch_zamba_train.py); xLSTM
    trains too (tests/test_torch_xlstm_train.py), and a hybrid without an
    SSM is what the check refuses."""
    _, tc = _cfgs()
    mamba = dataclasses.replace(
        tc, hybrid=dataclasses.replace(tc.hybrid, enabled=False))
    assert ttr.stack_plan(mamba) == "mamba"
    batch = {"inputs": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32),
             "weights": torch.ones((1, 4))}
    for cfg in (tc, mamba):
        ttr.check_supported(cfg)
        ttr.check_supported(cfg, serving=True)
        model = tbuild(cfg, "cpu")
        obj, w, met = model.loss_fn(model.init_params(0), batch)
        assert torch.isfinite(obj) and float(w) == 4.0
        assert float(met["aux"]) == 0.0
    ttr.check_supported(tcfgs.smoke_config("xlstm-125m"))
    with pytest.raises(ValueError, match="hybrid without an SSM"):
        ttr.check_supported(dataclasses.replace(
            tc, ssm=dataclasses.replace(tc.ssm, state_dim=0)))


def test_check_servable_on_the_card_names_kernel_widths():
    full = dataclasses.replace(tcfgs.resolve(ARCH), attention_impl="kernel")
    assert full.head_dim == 80
    ttr.check_servable(full, "cuda", paged=False)
    ttr.check_servable(full, "cuda")       # never meets the paged kernel
    odd = dataclasses.replace(full, head_dim=96)
    with pytest.raises(ValueError, match="prefill kernel needs head_dim"):
        ttr.check_servable(odd, "cuda", paged=False)
    ttr.check_servable(odd, "cpu", paged=False)
    wide = dataclasses.replace(full, ssm=dataclasses.replace(
        full.ssm, state_dim=128))
    with pytest.raises(ValueError, match="SSD kernel"):
        ttr.check_servable(wide, "cuda", paged=False)
    ttr.check_servable(dataclasses.replace(wide, attention_impl="reference"),
                       "cuda", paged=False)
    # the uniform plan's contiguous path: prefill kernel widths only
    olmo = dataclasses.replace(tcfgs.resolve("olmo-1b"),
                               attention_impl="kernel")
    ttr.check_servable(olmo, "cuda", paged=False)
    ttr.check_servable(olmo, "cuda")            # the decode kernel's 128
    with pytest.raises(ValueError, match=r"head_dim in \(64, 128\)"):
        ttr.check_servable(dataclasses.replace(olmo, head_dim=80), "cuda")


def test_paged_engine_refuses_zamba_as_jax_does(jax_side):
    """The serve CLI (paged engine) refuses zamba2 with the JAX
    package's message; the static path serves it."""
    _, jmodel, _, _ = jax_side
    with pytest.raises(ValueError, match="uniform attention stack only") \
            as jerr:
        jmodel.init_paged_cache(JLayout(block_size=4, num_blocks=8,
                                        max_blocks_per_seq=4))
    with pytest.raises(ValueError, match="uniform attention stack only") \
            as terr:
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert str(terr.value) == str(jerr.value)
