"""repro_torch's optimizers against the JAX package (CPU).

  (a) LAMB on parameter trees (``lamb.apply_update``) and on the packed
      bucket stack (the train step's ``steps.FlatUpdate.barrier``)
      against JAX's ``apply_update`` and ``apply_update_flat``, from the
      same numpy parameters, gradients and moments, with and without
      global-norm clipping, on the olmo-1b smoke tree (tied, no norm
      leaves) and the tinyllama-1.1b one (RMSNorm scales: per-layer
      vectors that the JAX package's stacked leaf makes a matrix);
  (b) AdamW on trees against JAX's on the same inputs (the decay rule
      of the stacked leaf);
  (c) JAX's ``decay_mask`` and ``segment_ids`` on the same layout equal
      to the port's per-bucket ``bucket_decay_mask`` rows and
      ``bucket_runs`` (the segment ids run-length coded);
  (d) the flat AdamW bitwise the port's tree AdamW in fp32 without
      clipping, and within 1e-6 of each leaf's largest magnitude with a
      clip (the two paths sum the global norm in another order);
  (e) LAMB's streamed form (``FlatUpdate.update_bucket`` in a shuffled
      flush order, then the trailing trust pass) bitwise its whole-stack
      barrier form (``FlatUpdate.barrier``).

Tolerances (fp32, the same elementwise math in another order for the
norms): parameters and moments 1e-6 of each leaf's largest magnitude,
grad norm 1e-6 and trust ratio 1e-5 relative (a ratio of two roots of
sums of up to ~1e5 squares in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.core import buckets as jbkt
from repro.models.model import build_model as jbuild
from repro.optim import adam as jadam
from repro.optim import lamb as jlamb
from repro_torch.configs import base as tcfgs
from repro_torch.core import buckets as tbkt
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim import adam as tadam
from repro_torch.optim import lamb as tlamb

ARCHS = ["olmo-1b", "tinyllama-1.1b"]
LEAF_TOL = 1e-6
GNORM_RTOL = 1e-6
TRUST_RTOL = 1e-5
BUCKET_MB = 0.02


def _case(arch, seed=0):
    """JAX-layout numpy trees (params, grads, m, v) and the port's
    config."""
    jc = jcfgs.smoke_config(arch)
    tc = tcfgs.smoke_config(arch)
    params = jax.tree.map(np.asarray, jbuild(jc).init_params(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)

    def draw(scale, positive=False):
        def f(a):
            x = rng.standard_normal(a.shape).astype(np.float32) * scale
            return np.abs(x) if positive else x
        return jax.tree.map(f, params)

    return (params, draw(0.05), draw(0.01), draw(1e-4, positive=True),
            tc)


def _ocfg(mod, clip, name="lamb"):
    return mod.OptimizerConfig(name=name, lr=0.1, weight_decay=0.01,
                               grad_clip=clip, warmup_steps=1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close(got, want, what, tol=LEAF_TOL):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), what
    for k, w in want.items():
        atol = tol * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


def _torch_state(tc, params, grads, m, v, step=3):
    def tree(t):
        return params_from_jax(t, tc, "cpu")
    state = tadam.AdamState(step=torch.tensor(step, dtype=torch.int32),
                            m=tree(m), v=tree(v))
    return tree(params), tree(grads), state


def _jax_state(params, grads, m, v, step=3):
    j = jax.tree.map(jnp.asarray, (params, grads, m, v))
    return j[0], j[1], jadam.AdamState(step=jnp.asarray(step, jnp.int32),
                                       m=j[2], v=j[3])


# --------------------------------------------------------------------------
# (a), (b) trees against JAX
# --------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["lamb", "adamw"])
def test_tree_update_matches_jax(name, arch, clip):
    params, grads, m, v, tc = _case(arch)
    jmod = jlamb if name == "lamb" else jadam
    tmod = tlamb if name == "lamb" else tadam
    jp, jg, js = _jax_state(params, grads, m, v)
    lr = 0.1
    jp2, js2, jmet = jmod.apply_update(jp, jg, js, _ocfg(jcfgs, clip, name),
                                       jnp.asarray(lr, jnp.float32))
    tp, tg, ts = _torch_state(tc, params, grads, m, v)
    tp2, ts2, tmet = tmod.apply_update(tp, tg, ts, _ocfg(tcfgs, clip, name),
                                       torch.tensor(lr))
    assert int(ts2.step) == int(js2.step) == 4
    _close(params_to_numpy(tp2), jax.device_get(jp2), "params")
    _close(params_to_numpy(ts2.m), jax.device_get(js2.m), "m")
    _close(params_to_numpy(ts2.v), jax.device_get(js2.v), "v")
    assert set(tmet) == set(jmet)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=GNORM_RTOL)
    if name == "lamb":
        np.testing.assert_allclose(float(tmet["trust_ratio"]),
                                   float(jmet["trust_ratio"]),
                                   rtol=TRUST_RTOL)


# --------------------------------------------------------------------------
# (c) the packed views of per-leaf structure
# --------------------------------------------------------------------------


def _layouts(arch, params_np, tc, multiple_of=512):
    jlo = jbkt.build_layout(jax.tree.map(jnp.asarray, params_np),
                            bucket_mb=BUCKET_MB, multiple_of=multiple_of)
    tlo = tbkt.build_layout(params_from_jax(params_np, tc, "cpu"),
                            bucket_mb=BUCKET_MB, multiple_of=multiple_of)
    return jlo, tlo


def _mask(tlo):
    """The whole stack's decay mask, a bucket's row at a time."""
    return torch.stack([tbkt.bucket_decay_mask(tlo, k)
                        for k in range(tlo.num_buckets)])


def _segments(tlo):
    """The whole stack's stream-leaf ids, decoded from the runs."""
    return np.stack([np.concatenate([np.full(hi - lo, i, np.int32)
                                     for lo, hi, i in tbkt.bucket_runs(
                                         tlo, k)])
                     for k in range(tlo.num_buckets)])


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_segment_ids_and_runs_match_jax(arch):
    params, _, _, _, tc = _case(arch)
    jlo, tlo = _layouts(arch, params, tc)
    assert tlo.num_buckets > 2 and tlo.padded_total > tlo.total
    mask = _mask(tlo)
    assert mask.dtype == torch.int8
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jbkt.decay_mask(jlo)))
    np.testing.assert_array_equal(_segments(tlo),
                                  np.asarray(jbkt.segment_ids(jlo)))


def _packed(tlo, *trees):
    return [tbkt.pack_buckets(t, tlo) for t in trees]


def _flat_update(tlo, ocfg, tp, mm, vv, step, lr):
    """The train step's packed update over the parameter tree ``tp``
    and the packed moments, the global weight 1 (gradients already
    scaled)."""
    opt = tadam.AdamState(step=step, m=mm, v=vv)
    flat = tsteps.FlatUpdate(tlo, ocfg, tp, opt, lr)
    flat.inv_w = torch.tensor(1.0)
    return flat


@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_lamb_flat_matches_jax(arch, clip):
    params, grads, m, v, tc = _case(arch)
    jlo, tlo = _layouts(arch, params, tc)
    tp, tg, ts = _torch_state(tc, params, grads, m, v)
    p, g, mm, vv = _packed(tlo, tp, tg, ts.m, ts.v)
    lr = 0.1
    jcs = (jnp.minimum(1.0, clip / jnp.maximum(jnp.sqrt(jnp.sum(
        jnp.asarray(g.numpy()) ** 2)), 1e-9)) if clip > 0 else None)
    want = jlamb.apply_update_flat(
        *(jnp.asarray(x.numpy().copy()) for x in (p, g, mm, vv)),
        jnp.asarray(4, jnp.int32), _ocfg(jcfgs, clip),
        jnp.asarray(lr, jnp.float32), decay_mask=jbkt.decay_mask(jlo),
        seg_ids=jbkt.segment_ids(jlo), num_leaves=len(jlo.sizes),
        clip_scale=jcs)
    flat = _flat_update(tlo, _ocfg(tcfgs, clip), tp, mm, vv, ts.step,
                        torch.tensor(lr))
    trust = flat.barrier(g)
    assert int(flat.step) == 4
    got = _packed(tlo, tp) + [mm, vv]
    for what, a, b in zip(("p", "m", "v"), got, want[:3]):
        w = np.asarray(b)
        np.testing.assert_allclose(
            a.numpy(), w, rtol=0,
            atol=LEAF_TOL * float(np.abs(w).max()), err_msg=what)
    np.testing.assert_allclose(float(trust), float(want[3]),
                               rtol=TRUST_RTOL)


# --------------------------------------------------------------------------
# (d) flat AdamW against the port's tree AdamW
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_flat_adamw_bitwise_tree_adamw_without_clip(arch):
    params, grads, m, v, tc = _case(arch)
    _, tlo = _layouts(arch, params, tc)
    tp, tg, ts = _torch_state(tc, params, grads, m, v)
    p, g, mm, vv = _packed(tlo, tp, tg, ts.m, ts.v)
    ocfg = _ocfg(tcfgs, 0.0, "adamw")
    lr = torch.tensor(0.1)
    fp, fm, fv = tadam.apply_update_flat(
        p, g, mm, vv, ts.step + 1, ocfg, lr, decay_mask=_mask(tlo))
    tp2, ts2, _ = tadam.apply_update(tp, tg, ts, ocfg, lr)
    for got, want in ((fp, tp2), (fm, ts2.m), (fv, ts2.v)):
        assert torch.equal(got, tbkt.pack_buckets(want, tlo))
    # the padding stays zero
    pad = torch.from_numpy(_segments(tlo) == len(tlo.sizes))
    assert not fp[pad].any() and not fm[pad].any() and not fv[pad].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_flat_adamw_with_clip_close_to_tree_adamw(arch):
    params, grads, m, v, tc = _case(arch)
    _, tlo = _layouts(arch, params, tc)
    tp, tg, ts = _torch_state(tc, params, grads, m, v)
    p, g, mm, vv = _packed(tlo, tp, tg, ts.m, ts.v)
    ocfg = _ocfg(tcfgs, 0.5, "adamw")
    lr = torch.tensor(0.1)
    cs = tadam.clip_scale(torch.sqrt(torch.sum(g * g)), 0.5)
    assert float(cs) < 1.0                      # the clip is active
    fp, fm, fv = tadam.apply_update_flat(
        p, g, mm, vv, ts.step + 1, ocfg, lr, decay_mask=_mask(tlo),
        clip_scale=cs)
    tp2, ts2, _ = tadam.apply_update(tp, tg, ts, ocfg, lr)
    for what, got, tree in (("p", fp, tp2), ("m", fm, ts2.m),
                            ("v", fv, ts2.v)):
        want = tbkt.pack_buckets(tree, tlo).numpy()
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=LEAF_TOL * float(np.abs(want).max()), err_msg=what)


# --------------------------------------------------------------------------
# (e) LAMB streamed against LAMB behind the barrier
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_lamb_streamed_form_bitwise_barrier_form(arch):
    params, grads, m, v, tc = _case(arch)
    _, tlo = _layouts(arch, params, tc)
    ocfg = _ocfg(tcfgs, 0.0)
    lr = torch.tensor(0.1)
    runs = {}
    for form in ("barrier", "streamed"):
        tp, tg, ts = _torch_state(tc, params, grads, m, v)
        g, mm, vv = _packed(tlo, tg, ts.m, ts.v)
        flat = _flat_update(tlo, ocfg, tp, mm, vv, ts.step, lr)
        if form == "barrier":
            trust = flat.barrier(g)
        else:
            # buckets land in a shuffled order, each writes its moments
            # and keeps its update and partials; one trailing trust pass
            for k in np.random.default_rng(7).permutation(tlo.num_buckets):
                flat.update_bucket(int(k), g[k])
            trust = flat.lamb_finish()
        runs[form] = (_packed(tlo, tp)[0], mm, vv, trust, flat.grad_norm())
    for a, b in zip(runs["streamed"], runs["barrier"]):
        assert torch.equal(a, b)
