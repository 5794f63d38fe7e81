"""repro_torch's absorbed-MLA serving path against the JAX package on the
CPU, at fp32 with numpy-seeded inputs:

* the plain MLA decode versions (dense, paged gather, and the online
  versions that follow the Pallas kernels step by step) against JAX's
  ``ref.mla_decode_dense``, ``ops.mla_decode_paged_attention(impl=
  "reference")`` and both Pallas kernels run in interpret mode, with NULL
  holes, ragged lengths and a length of exactly MB*bs (tolerance 1e-5:
  the same fp32 arithmetic summed in another order; outputs are O(1));
* the MLA block's queries, latent and prefill attention;
* the deepseek-v2 smoke config served by the port (``prefill_paged`` /
  ``decode_paged`` logits and both latent pools for every impl, tolerance
  2e-5 as in ``test_torch_serve.py``) against the JAX model, and a whole
  engine run against the JAX engine (identical greedy tokens and
  scheduling stats);
* the config field by field, the parameter tree and count, the
  ``params_from_jax``/``params_to_numpy`` round trip, and what the port
  still refuses (training MoE/MLA, widths the kernels do not take, a
  model deeper than the card).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import base as jcfgs
from repro.kernels.mla_decode import ops as jops
from repro.kernels.mla_decode import ref as jref
from repro.kernels.mla_decode.mla_decode import (mla_decode_paged_pallas,
                                                 mla_decode_pallas)
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import blocks as jblocks
from repro.models import model as jmodel_mod
from repro.models.kvcache import PagedLayout as JLayout
from repro.models.model import build_model as jbuild
from repro_torch.configs import base as tcfgs
from repro_torch.kernels.mla_decode import ops as tops
from repro_torch.kernels.mla_decode import ref as tref
from repro_torch.kernels.mla_decode.mla_decode import (mla_decode_cuda,
                                                       mla_decode_paged_cuda)
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.kvcache import PagedLayout as TLayout
from repro_torch.models.model import build_model as tbuild

ARCH = "deepseek-v2-236b"
KERNEL_TOL = 1e-5
TOL = 2e-5


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# --------------------------------------------------------------------------
# the MLA decode plain versions
# --------------------------------------------------------------------------

def _decode_inputs(rng, b, h, r, dr, s):
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(b, h, r), f(b, h, dr), f(b, s, r), f(b, s, dr)


@pytest.mark.parametrize("s,chunk,lens", [
    (40, 16, [40, 1, 17, 33]),        # S not a chunk multiple (padded)
    (64, 64, [64, 5, 63, 32]),        # one chunk
    (48, 512, [48, 48, 2, 30]),       # chunk larger than S
])
def test_contiguous_decode_plain_versions_match_jax(s, chunk, lens):
    rng = np.random.default_rng(s + chunk)
    qa, qr, ckv, kr = _decode_inputs(rng, 4, 4, 32, 16, s)
    kv_len = np.array(lens, np.int32)
    scale = 48 ** -0.5
    j_args = [jnp.asarray(a) for a in (qa, qr, ckv, kr, kv_len)]
    want = jref.mla_decode_dense(*j_args, scale)
    pallas = mla_decode_pallas(*j_args, scale, chunk=chunk, interpret=True)
    t_args = [torch.from_numpy(a) for a in (qa, qr, ckv, kr, kv_len)]
    online = tref.mla_decode_online_plain(*t_args, scale, chunk=chunk)
    _close(tref.mla_decode_dense(*t_args, scale), want, KERNEL_TOL)
    _close(online, want, KERNEL_TOL)
    _close(online, pallas, KERNEL_TOL)
    for impl in ("reference", "dense", "kernel"):
        got = tops.mla_decode_attention(*t_args, scale, impl=impl)
        assert got.dtype == torch.float32
        _close(got, want, KERNEL_TOL)
    with pytest.raises(ValueError, match="unknown mla decode impl"):
        tops.mla_decode_attention(*t_args, scale, impl="pallas")


def _paged_inputs(rng, b=5, h=4, r=32, dr=16, bs=4, mb=6):
    """Ragged lengths (one exactly MB*bs), NULL holes inside live
    windows, one all-NULL inactive slot with length 1, a shuffled pool."""
    n = b * mb
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    qa, qr = f(b, h, r), f(b, h, dr)
    ckv_pool, kr_pool = f(n, bs, r), f(n, bs, dr)
    lens = np.array([mb * bs, 1, 9, 14, 3][:b], np.int32)
    tables = np.full((b, mb), n, np.int32)
    perm = rng.permutation(n)
    used = 0
    for i, ln in enumerate(lens):
        if i == 1:
            continue                               # inactive slot
        nb = -(-int(ln) // bs)
        tables[i, :nb] = perm[used:used + nb]
        used += nb
    tables[0, 2] = n                               # NULL holes
    tables[3, 1] = n
    return qa, qr, ckv_pool, kr_pool, tables, lens


def test_paged_decode_plain_versions_match_jax():
    rng = np.random.default_rng(7)
    arrays = _paged_inputs(rng)
    scale = 48 ** -0.5
    j_args = [jnp.asarray(a) for a in arrays]
    want = jops.mla_decode_paged_attention(*j_args, scale, impl="reference")
    pallas = mla_decode_paged_pallas(*j_args, scale, interpret=True)
    t_args = [torch.from_numpy(a) for a in arrays]
    online = tref.mla_decode_paged_online_plain(*t_args, scale)
    _close(tref.mla_decode_paged_ref(*t_args, scale), want, KERNEL_TOL)
    _close(online, want, KERNEL_TOL)
    _close(online, pallas, KERNEL_TOL)
    for impl in ("reference", "dense", "kernel"):
        _close(tops.mla_decode_paged_attention(*t_args, scale, impl=impl),
               want, KERNEL_TOL)


def test_gather_blocks_reads_null_entries_as_zeros():
    pool = torch.arange(24, dtype=torch.float32).reshape(3, 2, 4) + 1
    tables = torch.tensor([[2, 3], [-1, 0]], dtype=torch.int32)
    win = tref.gather_blocks(pool, tables)
    assert win.shape == (2, 4, 4)
    assert torch.equal(win[0, :2], pool[2]) and not win[0, 2:].any()
    assert not win[1, :2].any() and torch.equal(win[1, 2:], pool[0])


def test_online_plain_rounds_p_to_the_cache_dtype():
    """In bf16 the online versions cast p to bf16 before the value
    product, as the Pallas kernel does: they then differ from the same
    arithmetic with p kept in fp32, and agree with it in fp32."""
    rng = np.random.default_rng(11)
    qa, qr, ckv, kr = (torch.from_numpy(a) for a in
                       _decode_inputs(rng, 2, 4, 32, 16, 24))
    kv_len = torch.tensor([24, 13], dtype=torch.int32)
    args = [t.to(torch.bfloat16) for t in (qa, qr, ckv, kr)]
    got = tref.mla_decode_online_plain(*args, kv_len, 0.2, chunk=8)
    upcast = tref.mla_decode_online_plain(*(a.float() for a in args),
                                          kv_len, 0.2, chunk=8)
    assert got.dtype == torch.float32
    assert not torch.equal(got, upcast)
    assert (got - upcast).abs().max() < 2e-2
    # p is the only rounding: fp32 inputs built from the bf16 values and
    # p rounded by hand reproduce the bf16 result exactly
    state = tref._online_init(args[0])
    for lo in range(0, 24, 8):
        kpos = torch.arange(lo, lo + 8)
        acc, m, l = state
        s = (torch.einsum("bhr,btr->bht", args[0].float(),
                          args[2][:, lo:lo + 8].float()) +
             torch.einsum("bhd,btd->bht", args[1].float(),
                          args[3][:, lo:lo + 8].float())) * 0.2
        s = torch.where(kpos[None, None] < kv_len[:, None, None], s, -1e30)
        m_new = torch.maximum(m, s.max(-1).values)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        acc = acc * corr[..., None] + torch.einsum(
            "bht,btr->bhr", p.to(torch.bfloat16).float(),
            args[2][:, lo:lo + 8].float())
        state = (acc, m_new, l * corr + p.sum(-1))
    assert torch.equal(got, tref._online_finish(state))


def test_mla_kernel_wrappers_run_the_plain_versions_on_cpu():
    rng = np.random.default_rng(5)
    arrays = [torch.from_numpy(a) for a in _paged_inputs(rng)]
    n0 = (mla_decode_cuda.launches, mla_decode_paged_cuda.launches)
    got = mla_decode_paged_cuda(*arrays, 0.3)
    assert torch.equal(got, tref.mla_decode_paged_online_plain(*arrays, 0.3))
    qa, qr, ckv, kr = (torch.from_numpy(a) for a in
                       _decode_inputs(rng, 2, 4, 32, 16, 20))
    lens = torch.tensor([20, 7], dtype=torch.int32)
    assert torch.equal(mla_decode_cuda(qa, qr, ckv, kr, lens, 0.3),
                       tref.mla_decode_online_plain(qa, qr, ckv, kr, lens,
                                                    0.3))
    assert (mla_decode_cuda.launches, mla_decode_paged_cuda.launches) == n0


# --------------------------------------------------------------------------
# the MLA block
# --------------------------------------------------------------------------

def _block_cfgs(impl="reference"):
    jc = dataclasses.replace(jcfgs.smoke_config(ARCH),
                             compute_dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config(ARCH),
                             compute_dtype="float32", attention_impl=impl)
    return jc, tc


def _mla_params(rng, cfg):
    jp = jax.tree.map(np.asarray, jblocks.init_mla(
        cfg, jax.random.PRNGKey(int(rng.integers(1 << 30)))))
    # non-trivial norm scales, so the test sees them applied
    jp["kv_norm"] = (1 + 0.1 * rng.standard_normal(
        jp["kv_norm"].shape)).astype(np.float32)
    jp["q_norm"] = (1 + 0.1 * rng.standard_normal(
        jp["q_norm"].shape)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in jp.items()},
            {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in jp.items()})


@pytest.mark.parametrize("impl", ["reference", "dense", "kernel"])
def test_mla_block_matches_jax(impl):
    jc, tc = _block_cfgs(impl)
    rng = np.random.default_rng(2)
    jp, tp = _mla_params(rng, jc)
    x = rng.standard_normal((2, 9, jc.d_model)).astype(np.float32)
    pos = np.arange(9)
    jq = jblocks.mla_queries(jp, jnp.asarray(x), jc, jnp.asarray(pos))
    tq = tblocks.mla_queries(tp, torch.from_numpy(x), tc,
                             torch.from_numpy(pos))
    jl = jblocks.mla_latent(jp, jnp.asarray(x), jc, jnp.asarray(pos))
    tl = tblocks.mla_latent(tp, torch.from_numpy(x), tc,
                            torch.from_numpy(pos))
    for t, j in list(zip(tq, jq)) + list(zip(tl, jl)):
        _close(t, j, TOL)
    jy, jkv = jblocks.mla_block(jp, jnp.asarray(x), jc, jblocks.LOCAL_CTX,
                                jnp.asarray(pos), return_kv=True)
    ty, tkv = tblocks.mla_block(tp, torch.from_numpy(x), tc,
                                torch.from_numpy(pos), return_kv=True)
    _close(ty, jy, TOL)
    for t, j in zip(tkv, jkv):
        _close(t, j, TOL)


# --------------------------------------------------------------------------
# the deepseek-v2 smoke model served, against JAX
# --------------------------------------------------------------------------

def _jax_side():
    cfg = dataclasses.replace(jcfgs.smoke_config(ARCH),
                              compute_dtype="float32")
    model = jbuild(cfg)
    return cfg, model, jax.jit(model.init_params)(jax.random.PRNGKey(0))


def _torch_side(jparams, impl):
    cfg = dataclasses.replace(tcfgs.smoke_config(ARCH),
                              compute_dtype="float32", attention_impl=impl)
    return cfg, tbuild(cfg, "cpu"), params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.mark.parametrize("impl", ["reference", "dense", "kernel"])
def test_paged_prefill_and_decode_match_jax(impl):
    """Three sequences at depths 5/9/12 in one 16-position layout with a
    NULL entry in one table: bucket-padded prefill (the MoE layers at the
    eval capacity), then one decode step at each sequence's own depth
    (no-drop capacity); logits and both latent pools agree."""
    jcfg, jmodel, jparams = _jax_side()
    tcfg, tmodel, tparams = _torch_side(jparams, impl)
    rng = np.random.default_rng(1)
    bs, batch, s_pad = 4, 3, 12
    lens = np.array([5, 9, 12], np.int32)
    tables = np.array([[0, 1, 2, 13], [4, 5, 6, 7], [8, 9, 10, 11]],
                      np.int32)
    tables[0, 3] = 14                    # NULL: one past the 14-block pool
    x = rng.integers(0, jcfg.vocab_size, (batch, 16)).astype(np.int32)
    nxt = x[np.arange(batch), lens]

    jc = jmodel.init_paged_cache(JLayout(block_size=bs, num_blocks=14,
                                         max_blocks_per_seq=4))
    jpre, jc = jmodel.prefill_paged(jparams, jnp.asarray(x[:, :s_pad]),
                                    jnp.asarray(lens), jc,
                                    jnp.asarray(tables))
    jdec, jc = jmodel.decode_paged(jparams, jnp.asarray(nxt), jc,
                                   jnp.asarray(tables), jnp.asarray(lens))

    tc = tmodel.init_paged_cache(TLayout(block_size=bs, num_blocks=14,
                                         max_blocks_per_seq=4))
    assert sorted(tc) == ["c_kv", "k_rope"]
    assert tc["c_kv"].shape == (2, 14, bs, tcfg.mla.kv_lora_rank)
    assert tc["k_rope"].shape == (2, 14, bs, tcfg.mla.rope_head_dim)
    tpre, tc = tmodel.prefill_paged(tparams, torch.from_numpy(x[:, :s_pad]),
                                    torch.from_numpy(lens), tc,
                                    torch.from_numpy(tables))
    tdec, tc = tmodel.decode_paged(tparams, torch.from_numpy(nxt), tc,
                                   torch.from_numpy(tables),
                                   torch.from_numpy(lens))
    _close(tpre, jpre, TOL)
    _close(tdec, jdec, TOL)
    for name in ("c_kv", "k_rope"):
        _close(tc[name], jc[name], TOL)


def test_engine_tokens_and_stats_match_jax_engine():
    """deepseek-v2 smoke through the port's engine (CPU, impl "kernel" =
    plain versions) and the JAX engine on a one-device mesh of Auto axes
    with impl "reference", on one synthetic trace: identical greedy
    tokens and scheduling; the pool is small enough to preempt."""
    _, jmodel, _ = _jax_side()
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jparams = jsteps.init_params_sharded(jmodel, mesh, jax.random.PRNGKey(0))
    _, tmodel, tparams = _torch_side(jparams, "kernel")
    kw = dict(n=10, vocab=jmodel.cfg.vocab_size, rate=0.5,
              prompt_lens=(4, 24), gen_lens=(2, 12), seed=3)
    reqs = jserve.synthetic_requests(**kw)
    geo = dict(block_size=4, num_blocks=18, max_blocks_per_seq=9)
    with compat.set_mesh(mesh):
        jeng = jserve.build_engine(jmodel, jparams, mesh, JLayout(**geo),
                                   slots=4, prefill_batch=2,
                                   pod_speeds=[1.0, 0.5])
        jres = jeng.run(reqs)
    teng = tserve.build_engine(tmodel, tparams, TLayout(**geo), slots=4,
                               prefill_batch=2, pod_speeds=[1.0, 0.5])
    tres = teng.run(tserve.synthetic_requests(**kw))
    assert tres.tokens == jres.tokens
    for key in ("decode_steps", "prefill_groups", "preemptions",
                "pod_limits", "total_tokens", "peak_active_per_pod"):
        assert tres.stats[key] == jres.stats[key], key
    assert jres.stats["preemptions"] > 0
    assert tres.stats["kernel_launches"] == {
        "flash_attention_cuda": 0, "flash_decode_paged_cuda": 0,
        "mla_decode_paged_cuda": 0}


def test_cli_serves_the_deepseek_smoke_config_on_cpu(capsys):
    res = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "4", "--slots", "2"])
    assert res.stats["requests"] == 4 and res.stats["total_tokens"] > 0
    assert "deepseek-v2-236b-smoke on cpu" in capsys.readouterr().out


# --------------------------------------------------------------------------
# config, parameters, conversion, refusals
# --------------------------------------------------------------------------

def _port_impl(name):
    return "kernel" if name == "pallas" else name


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_config_matches_jax_field_by_field(which):
    get = {"smoke": "smoke_config", "full": "resolve"}[which]
    for impl in jcfgs.ATTENTION_IMPLS:
        jc = dataclasses.replace(getattr(jcfgs, get)(ARCH),
                                 attention_impl=impl)
        tc = dataclasses.replace(getattr(tcfgs, get)(ARCH),
                                 attention_impl=_port_impl(impl))
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        jd["attention_impl"] = _port_impl(jd["attention_impl"])
        assert td == jd
    assert tc.param_count() == jmodel_mod.count_params_analytic(jc)


def test_param_tree_shapes_and_count_match_jax():
    cfg = tcfgs.smoke_config(ARCH)
    jcfg = jcfgs.smoke_config(ARCH)
    jp = jax.eval_shape(jbuild(jcfg).init_params, jax.random.PRNGKey(0))
    tp = ttr.init_params(cfg, 0, "cpu")
    t_layers = tp["layers"]
    assert len(t_layers) == cfg.num_layers
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp["layers"])[0])
    for path, leaf in flat_j.items():
        node = t_layers[0]
        for key in path:
            node = node[key.key]
        assert (cfg.num_layers,) + tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    n = sum(t.numel() for t in ttr.tree_leaves(tp))
    assert n == cfg.param_count() == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jp))


def test_params_round_trip_through_the_jax_layout():
    _, _, jparams = _jax_side()
    tree = jax.tree.map(np.asarray, jparams)
    cfg = dataclasses.replace(tcfgs.smoke_config(ARCH),
                              compute_dtype="float32")
    tp = params_from_jax(tree, cfg, "cpu")
    assert set(tp["layers"][0]["moe"]) == {"router", "w_gate", "w_up",
                                           "w_down", "shared"}
    assert tp["layers"][1]["moe"]["w_gate"].shape == (4, 64, 96)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_training_moe_and_mla_is_refused():
    """MoE and MLA training are ported (tests/test_torch_moe_train.py):
    the config check passes deepseek-v2 and ``loss_fn`` trains it, aux
    loss in its metrics; the SSM, hybrid and xLSTM plans train too
    (tests/test_torch_zamba_train.py, tests/test_torch_xlstm_train.py),
    and a hybrid without an SSM is what is still refused."""
    cfg = dataclasses.replace(tcfgs.smoke_config(ARCH),
                              compute_dtype="float32")
    model = tbuild(cfg, "cpu")
    params = model.init_params(0)
    batch = {"inputs": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32),
             "weights": torch.ones((1, 4))}
    ttr.check_supported(cfg)
    ttr.check_supported(cfg, serving=True)
    obj, w, met = model.loss_fn(params, batch)
    assert torch.isfinite(obj) and float(w) == 4.0
    assert float(met["aux"]) > 0
    zamba = tcfgs.smoke_config("zamba2-2.7b")
    mamba = dataclasses.replace(
        zamba, hybrid=dataclasses.replace(zamba.hybrid, enabled=False))
    for c in (zamba, mamba, tcfgs.smoke_config("xlstm-125m")):
        ttr.check_supported(c)
    with pytest.raises(ValueError, match="hybrid without an SSM.*not "
                                         "ported"):
        ttr.check_supported(dataclasses.replace(
            zamba, ssm=dataclasses.replace(zamba.ssm, state_dim=0)))


def test_check_servable_on_the_card_names_kernel_widths():
    full = dataclasses.replace(tcfgs.resolve(ARCH), attention_impl="kernel")
    ttr.check_servable(full, "cuda")            # widths the kernels take
    ttr.check_servable(dataclasses.replace(full, num_layers=8), "cuda")
    narrow = dataclasses.replace(
        full, mla=dataclasses.replace(full.mla, rope_head_dim=32))
    with pytest.raises(ValueError, match="rope_head_dim 64"):
        ttr.check_servable(narrow, "cuda")
    ttr.check_servable(narrow, "cpu")           # plain versions: any width
    ttr.check_servable(dataclasses.replace(narrow,
                                           attention_impl="reference"),
                       "cuda")
    gqa = dataclasses.replace(tcfgs.resolve("olmo-1b"),
                              attention_impl="kernel")
    ttr.check_servable(gqa, "cuda")             # head dim 128 is built
    with pytest.raises(ValueError, match=r"head_dim in \(64, 128\)"):
        ttr.check_servable(dataclasses.replace(gqa, head_dim=80), "cuda")


def test_full_depth_deepseek_refused_before_allocating(monkeypatch):
    """At 60 layers the weights need ~478 GB: the serve CLI names the bytes
    needed and the card's bytes before it allocates anything; 8 layers
    fit an 80 GB card."""
    card = types.SimpleNamespace(total_memory=85_520_809_984)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: card)
    full = tcfgs.resolve(ARCH)
    need = tserve.weight_bytes(full)
    assert need == full.param_count() * 2 and need > 470e9
    with pytest.raises(ValueError, match=rf"need {need} bytes .* has "
                                         rf"{card.total_memory} bytes"):
        tserve.main(["--arch", ARCH])
    eight = dataclasses.replace(full, num_layers=8)
    assert 65e9 < tserve.weight_bytes(eight) < 66e9
    tserve.check_fits(eight, torch.device("cuda"))
