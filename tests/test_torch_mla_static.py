"""repro_torch's absorbed-MLA static path (the contiguous latent cache of
``static_generate``) against the JAX package on the CPU, at the
deepseek-v2 smoke config in fp32 with numpy-seeded inputs:

* ``init_mla_cache``: the JAX cache's shapes and dtypes;
* ``mla_decode`` (output and both caches, written in place) against
  ``repro.models.kvcache.mla_decode`` under the reference path and the
  kernel path (on the CPU the kernel's plain version);
* the smoke model's prefill cache and two decode steps (logits and both
  caches), ``static_generate`` tokens identical to JAX's on a (1, 1)
  mesh of Auto axes, and to the port's own paged engine on one sequence;
* what the card would take: the full config passes ``check_servable``
  for the static path.

Tolerance: 2e-5 absolute on logits and caches (the same fp32 arithmetic
summed in another order; values here are O(1)), as in
``test_torch_mla.py``; tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import base as jcfgs
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import blocks as jblocks
from repro.models import kvcache as jkv
from repro.models.model import build_model as jbuild
from repro_torch.configs import base as tcfgs
from repro_torch.kernels.mla_decode.mla_decode import mla_decode_cuda
from repro_torch.launch import serve as tserve
from repro_torch.models import kvcache as tkv
from repro_torch.models import transformer as ttr
from repro_torch.models.blocks import dtype_of
from repro_torch.models.convert import params_from_jax
from repro_torch.models.kvcache import PagedLayout as TLayout
from repro_torch.models.model import build_model as tbuild
from repro_torch.serve import Request

ARCH = "deepseek-v2-236b"
TOL = 2e-5
IMPLS = ["reference", "kernel"]


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _cfgs(impl="reference", dtype="float32"):
    jc = dataclasses.replace(jcfgs.smoke_config(ARCH), compute_dtype=dtype)
    tc = dataclasses.replace(tcfgs.smoke_config(ARCH), compute_dtype=dtype,
                             attention_impl=impl)
    return jc, tc


def _auto_mesh():
    # Auto axes: jax's default Explicit axes raise a ShardingTypeError in
    # the JAX embedding gather (ROADMAP §3)
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _models(impl):
    jcfg, tcfg = _cfgs(impl)
    mesh = _auto_mesh()
    jmodel = jbuild(jcfg)
    jparams = jsteps.init_params_sharded(jmodel, mesh, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return mesh, jmodel, jparams, tbuild(tcfg, "cpu"), tparams


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mla_cache_matches_jax(dtype):
    jc, tc = _cfgs(dtype=dtype)
    want = jkv.init_mla_cache(jc, 3, 2, 17)
    got = tkv.init_mla_cache(tc, 3, 2, 17, "cpu")
    assert sorted(got) == sorted(want) == ["c_kv", "k_rope"]
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype)
        assert not t.any()
    cache = ttr.init_cache(tc, 2, 17, "cpu")
    assert cache["c_kv"].shape == (tc.num_layers, 2, 17,
                                   tc.mla.kv_lora_rank)
    assert cache["k_rope"].dtype == dtype_of(dtype)


@pytest.mark.parametrize("impl", IMPLS)
def test_mla_decode_matches_jax(impl):
    """One token at position 6 of a 9-position cache whose first six
    positions hold random latents (and the rest junk the mask must hide):
    output and both caches, the caches written in place. The kernel path
    counts no launch on the CPU."""
    jc, tc = _cfgs(impl)
    rng = np.random.default_rng(3)
    jp = jax.tree.map(np.asarray, jblocks.init_mla(jc, jax.random.PRNGKey(5)))
    for k in ("kv_norm", "q_norm"):          # non-trivial norm scales
        jp[k] = (1 + 0.1 * rng.standard_normal(jp[k].shape)).astype(
            np.float32)
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    b, s, pos = 2, 9, 6
    m = jc.mla
    x = rng.standard_normal((b, 1, jc.d_model)).astype(np.float32)
    ckv = rng.standard_normal((b, s, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, s, m.rope_head_dim)).astype(np.float32)
    jy, (jckv, jkr) = jkv.mla_decode(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x), jc,
        jblocks.LOCAL_CTX, jnp.asarray(ckv), jnp.asarray(kr),
        jnp.int32(pos))
    t_ckv, t_kr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    kv_len = torch.full((b,), pos + 1, dtype=torch.int32)
    n0 = mla_decode_cuda.launches
    ty, (out_ckv, out_kr) = tkv.mla_decode(tp, torch.from_numpy(x), tc,
                                           t_ckv, t_kr, pos, kv_len)
    assert mla_decode_cuda.launches == n0
    assert out_ckv is t_ckv and out_kr is t_kr
    _close(ty, jy)
    _close(t_ckv, jckv)
    _close(t_kr, jkr)
    with pytest.raises(ValueError, match="kv_len of shape"):
        tkv.mla_decode(tp, torch.from_numpy(x), tc, t_ckv, t_kr, pos,
                       kv_len[:1])


@pytest.mark.parametrize("impl", IMPLS)
def test_static_path_matches_jax(impl):
    """The smoke model over the contiguous MLA cache: prefill logits and
    cache (padded to max_len), two decode steps (logits and both caches),
    and ``static_generate`` tokens identical to JAX's."""
    mesh, jmodel, jparams, tmodel, tparams = _models(impl)
    x = np.random.default_rng(4).integers(
        0, jmodel.cfg.vocab_size, (2, 13)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(x[:, :11]), max_len=14)
    tl, tc = tmodel.prefill(tparams, torch.from_numpy(x[:, :11]),
                            max_len=14)
    assert tc["c_kv"].shape == (2, 2, 14, tmodel.cfg.mla.kv_lora_rank)
    for pos in (11, 12):
        _close(tl, jl)
        for name in ("c_kv", "k_rope"):
            _close(tc[name], jc[name])
        jl, jc = jmodel.decode(jparams, jnp.asarray(x[:, pos]), jc,
                               jnp.int32(pos))
        tl, tc = tmodel.decode(tparams, torch.from_numpy(x[:, pos]), tc, pos)
    _close(tl, jl)
    for name in ("c_kv", "k_rope"):
        _close(tc[name], jc[name])
    prompts = x[:, :9]
    with compat.set_mesh(mesh):
        want = jserve.static_generate(jmodel, jparams, mesh, prompts, 8)
    got = tserve.static_generate(tmodel, tparams, prompts, 8)
    assert got.shape == (2, 8) and np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("impl", IMPLS)
def test_static_generate_equals_the_paged_engine_on_one_sequence(impl):
    """One sequence through the port's paged engine (block tables, the
    paged MLA decode) and through ``static_generate`` (the contiguous
    cache): identical greedy tokens, fp32."""
    _, tcfg = _cfgs(impl)
    tmodel = tbuild(tcfg, "cpu")
    tparams = tmodel.init_params(0)
    plen, gen = 7, 6
    prompt = tuple(int(t) for t in np.random.default_rng(1).integers(
        0, tcfg.vocab_size, plen))
    mbs = -(-(plen + gen) // 4)
    eng = tserve.build_engine(
        tmodel, tparams, TLayout(block_size=4, num_blocks=2 * mbs,
                                 max_blocks_per_seq=mbs),
        slots=2, prefill_batch=1, pod_speeds=[1.0])
    paged = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=gen,
                             arrival=0.0)]).tokens[0]
    static = tserve.static_generate(tmodel, tparams,
                                    np.asarray([prompt], np.int32), gen)
    assert [int(t) for t in static[0]] == list(paged)


def test_check_servable_passes_the_static_path_on_the_card():
    """The full config, and the 8-layer cut the card serves, pass the
    checks of the static path (the MLA widths are the kernels'); a RoPE
    width the kernels do not take is refused there as on the paged
    path."""
    full = dataclasses.replace(tcfgs.resolve(ARCH), attention_impl="kernel")
    ttr.check_servable(full, "cuda", paged=False)
    ttr.check_servable(dataclasses.replace(full, num_layers=8), "cuda",
                       paged=False)
    narrow = dataclasses.replace(
        full, mla=dataclasses.replace(full.mla, rope_head_dim=32))
    with pytest.raises(ValueError, match="rope_head_dim 64"):
        ttr.check_servable(narrow, "cuda", paged=False)
