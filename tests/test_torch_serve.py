"""repro_torch serving path against the JAX package on the tinyllama
smoke config at fp32, with the JAX ``init_params`` carried over by
``params_from_jax``: paged prefill/decode logits and pools, a whole
engine run (identical greedy tokens and scheduling stats), the
contiguous-cache static path (prefill cache and decode against JAX's,
``static_generate`` tokens identical to JAX's and, for one sequence, to
the port's own paged engine, the invariant
``benchmarks/serve_bench.py`` asserts in JAX), and the configs and CLI
flags field by field.

Tolerance for logits and pools: 2e-5 absolute (the same fp32 arithmetic
in another summation order; logits here are O(1)).
"""
import argparse
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import base as jcfgs
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models.kvcache import PagedLayout as JLayout
from repro.models.model import build_model as jbuild
from repro_torch.configs import base as tcfgs
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.kvcache import PagedLayout as TLayout
from repro_torch.models.model import build_model as tbuild
from repro_torch.serve import Request

TOL = 2e-5
ARCH = "tinyllama-1.1b"


def _jax_side(impl="reference"):
    cfg = dataclasses.replace(jcfgs.smoke_config(ARCH),
                              compute_dtype="float32", attention_impl=impl)
    model = jbuild(cfg)
    params = jax.jit(model.init_params)(jax.random.PRNGKey(0))
    return cfg, model, params


def _torch_side(jparams, impl):
    cfg = dataclasses.replace(tcfgs.smoke_config(ARCH),
                              compute_dtype="float32", attention_impl=impl)
    model = tbuild(cfg, "cpu")
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, model, params_from_jax(tree, cfg, "cpu")


@pytest.mark.parametrize("impl", ["reference", "dense", "kernel"])
def test_paged_prefill_and_decode_match_jax(impl):
    """Three sequences at depths 5/9/12 in one 16-position layout with a
    NULL entry in one table: bucket-padded prefill, then one decode step
    at each sequence's own depth; logits and both pools agree."""
    jcfg, jmodel, jparams = _jax_side()
    _, tmodel, tparams = _torch_side(jparams, impl)
    rng = np.random.default_rng(1)
    bs, batch, s_pad = 4, 3, 12
    lens = np.array([5, 9, 12], np.int32)
    tables = np.array([[0, 1, 2, 13], [4, 5, 6, 7], [8, 9, 10, 11]],
                      np.int32)
    tables[0, 3] = 14                    # NULL: one past the 14-block pool
    x = rng.integers(0, jcfg.vocab_size, (batch, 16)).astype(np.int32)
    nxt = x[np.arange(batch), lens]

    jl = JLayout(block_size=bs, num_blocks=14, max_blocks_per_seq=4)
    jc = jmodel.init_paged_cache(jl)
    jpre, jc = jmodel.prefill_paged(jparams, jnp.asarray(x[:, :s_pad]),
                                    jnp.asarray(lens), jc,
                                    jnp.asarray(tables))
    jdec, jc = jmodel.decode_paged(jparams, jnp.asarray(nxt), jc,
                                   jnp.asarray(tables), jnp.asarray(lens))

    tl = TLayout(block_size=bs, num_blocks=14, max_blocks_per_seq=4)
    tc = tmodel.init_paged_cache(tl)
    tpre, tc = tmodel.prefill_paged(tparams, torch.from_numpy(x[:, :s_pad]),
                                    torch.from_numpy(lens), tc,
                                    torch.from_numpy(tables))
    tdec, tc = tmodel.decode_paged(tparams, torch.from_numpy(nxt), tc,
                                   torch.from_numpy(tables),
                                   torch.from_numpy(lens))

    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), atol=TOL,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=TOL, rtol=0)


def test_engine_tokens_and_stats_match_jax_engine():
    """The port's engine (CPU, impl "kernel" = plain versions) against the
    JAX engine on a one-device mesh with impl "reference", on the same
    synthetic trace: identical greedy tokens for every request and
    identical scheduling (decode steps, prefill groups, preemptions, pod
    limits). The pool is small enough to force preemptions."""
    _, jmodel, _ = _jax_side()
    # Auto axes: on a mesh of Explicit axes (jax.make_mesh's default on
    # newer jax) the JAX embedding gather of this config raises a
    # ShardingTypeError, a fault of the reference recorded in ROADMAP.md
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jparams = jsteps.init_params_sharded(jmodel, mesh, jax.random.PRNGKey(0))
    _, tmodel, tparams = _torch_side(jparams, "kernel")
    kw = dict(n=10, vocab=jmodel.cfg.vocab_size, rate=0.5,
              prompt_lens=(4, 24), gen_lens=(2, 12), seed=3)
    jreqs = jserve.synthetic_requests(**kw)
    treqs = tserve.synthetic_requests(**kw)
    assert [dataclasses.astuple(r) for r in jreqs] == \
        [dataclasses.astuple(r) for r in treqs]
    geo = dict(block_size=4, num_blocks=18, max_blocks_per_seq=9)
    with compat.set_mesh(mesh):
        jeng = jserve.build_engine(jmodel, jparams, mesh, JLayout(**geo),
                                   slots=4, prefill_batch=2,
                                   pod_speeds=[1.0, 0.5])
        jres = jeng.run(jreqs)
    teng = tserve.build_engine(tmodel, tparams, TLayout(**geo), slots=4,
                               prefill_batch=2, pod_speeds=[1.0, 0.5])
    tres = teng.run(treqs)
    assert tres.tokens == jres.tokens
    for key in ("decode_steps", "prefill_groups", "preemptions",
                "pod_limits", "total_tokens", "peak_active_per_pod"):
        assert tres.stats[key] == jres.stats[key], key
    assert jres.stats["preemptions"] > 0
    assert tres.stats["attention_impl"] == "kernel"
    assert tres.stats["kernel_launches"] == {
        "flash_attention_cuda": 0, "flash_decode_paged_cuda": 0,
        "mla_decode_paged_cuda": 0}
    for r in treqs:
        assert len(tres.tokens[r.rid]) == r.max_new_tokens


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_static_path_matches_jax(impl):
    """The uniform GQA plan over the contiguous cache: prefill logits and
    cache, two decode steps (the dense oracle over ``pos + 1``
    positions), and ``static_generate`` tokens identical to JAX's."""
    jcfg, jmodel, _ = _jax_side()
    mesh = _auto_mesh()
    jparams = jsteps.init_params_sharded(jmodel, mesh, jax.random.PRNGKey(0))
    _, tmodel, tparams = _torch_side(jparams, impl)
    x = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(x[:, :11]), max_len=14)
    tl, tc = tmodel.prefill(tparams, torch.from_numpy(x[:, :11]),
                            max_len=14)
    for pos in (11, 12):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), atol=TOL,
                                       rtol=0)
        jl, jc = jmodel.decode(jparams, jnp.asarray(x[:, pos]), jc,
                               jnp.int32(pos))
        tl, tc = tmodel.decode(tparams, torch.from_numpy(x[:, pos]), tc, pos)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    prompts = x[:, :9]
    with compat.set_mesh(mesh):
        want = jserve.static_generate(jmodel, jparams, mesh, prompts, 8)
    got = tserve.static_generate(tmodel, tparams, prompts, 8)
    assert got.shape == (2, 8) and np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_static_generate_equals_the_paged_engine_on_one_sequence(impl):
    """For a single sequence the paged path is an implementation detail:
    the engine's tokens (block tables, bucket-padded prefill) equal
    ``static_generate``'s (contiguous cache, scalar position), fp32."""
    jcfg, _, jparams = _jax_side()
    _, tmodel, tparams = _torch_side(jparams, impl)
    plen, gen = 7, 6
    prompt = tuple(int(t) for t in np.random.default_rng(1).integers(
        0, jcfg.vocab_size, plen))
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


def _port_impl(name):
    return "kernel" if name == "pallas" else name


# every arch the JAX package registers; tinyllama's cases keep their
# first ids
ALL_ARCHS = ["arctic-480b", "chameleon-34b", "deepseek-v2-236b", "glm4-9b",
             "musicgen-large", "olmo-1b", "phi4-mini-3.8b", ARCH,
             "xlstm-125m", "zamba2-2.7b"]


@pytest.mark.parametrize("which,arch", [
    pytest.param(w, a, id=w if a == ARCH else f"{w}-{a}")
    for w in ("smoke", "full") for a in ALL_ARCHS])
def test_configs_match_jax_field_by_field(which, arch):
    get = {"smoke": "smoke_config", "full": "resolve"}[which]
    jcfgs.resolve(ARCH)                 # loads the JAX registry
    assert sorted(jcfgs._REGISTRY) == sorted(ALL_ARCHS)
    for impl in jcfgs.ATTENTION_IMPLS:
        jc = dataclasses.replace(getattr(jcfgs, get)(arch),
                                 attention_impl=impl)
        tc = dataclasses.replace(getattr(tcfgs, get)(arch),
                                 attention_impl=_port_impl(impl))
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        jd["attention_impl"] = _port_impl(jd["attention_impl"])
        assert td == jd
        assert tc.head_dim == jc.head_dim and tc.q_per_kv == jc.q_per_kv
    assert tcfgs.ATTENTION_IMPLS == tuple(
        _port_impl(i) for i in jcfgs.ATTENTION_IMPLS)
    with pytest.raises(ValueError, match="attention_impl"):
        dataclasses.replace(tcfgs.smoke_config(arch), attention_impl="pallas")


def _flags(main):
    seen = {}
    orig = argparse.ArgumentParser.parse_args
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
    return seen


def test_serve_cli_flags_match_jax_plus_device():
    """Same flags and defaults as the JAX driver, plus --device; the
    attention impls are the port's names with "kernel" the default."""
    jf, tf = _flags(jserve.main), _flags(tserve.main)
    assert set(tf) == set(jf) | {"--device"}
    for flag in jf:
        if flag != "--attention-impl":
            assert tf[flag].default == jf[flag].default, flag
    assert tf["--device"].default == "cuda"
    assert list(tf["--attention-impl"].choices) == list(tcfgs.ATTENTION_IMPLS)
    assert tf["--attention-impl"].default == "kernel"
