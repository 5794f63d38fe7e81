"""repro_torch's MoE block against the JAX package's on the CPU, at fp32
on the deepseek-v2 smoke config (4 experts, top-2, one shared expert),
with numpy-seeded weights and inputs handed to both: the router (gates,
expert ids, aux loss) and ``moe_block`` against the JAX
``moe_block(train=False)`` at prefill (eval capacity), with the capacity
lowered until tokens drop, and at a single-token decode (no-drop
capacity).

Tolerance 2e-5 absolute: the same fp32 arithmetic in another summation
order; outputs are O(1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.models import blocks as jblocks
from repro_torch.configs import base as tcfgs
from repro_torch.models import blocks as tblocks

ARCH = "deepseek-v2-236b"
TOL = 2e-5


def _cfgs(**moe):
    jc = dataclasses.replace(jcfgs.smoke_config(ARCH),
                             compute_dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config(ARCH),
                             compute_dtype="float32")
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


def _params(cfg, seed):
    jp = jax.tree.map(np.asarray, jblocks.init_moe(
        cfg, jax.random.PRNGKey(seed)))

    def to_jax(t):
        return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
                for k, v in t.items()}

    def to_torch(t):
        return {k: to_torch(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)) for k, v in t.items()}
    return to_jax(jp), to_torch(jp)


def _x(rng, b, s, d):
    return rng.standard_normal((b, s, d)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)


def test_router_matches_jax():
    jc, tc = _cfgs()
    jp, tp = _params(jc, 0)
    x = _x(np.random.default_rng(0), 1, 40, jc.d_model)[0]
    jg, je, ja = jblocks._router(jp, jnp.asarray(x), jc)
    tg, te, ta = tblocks._router(tp, torch.from_numpy(x), tc)
    assert torch.equal(te, torch.from_numpy(np.array(je)).long())
    _close(tg, jg)
    _close(ta, ja)


def _dropped(tc, tp, x):
    """Routing slots past their expert's capacity in this batch."""
    b, s, d = x.shape
    _, eidx, _ = tblocks._router(tp, torch.from_numpy(x).reshape(-1, d), tc)
    cap = tblocks.moe_capacity(tc, b * s, s)
    load = torch.bincount(eidx.reshape(-1), minlength=tc.moe.num_experts)
    return int(torch.clamp(load - cap, min=0).sum())


@pytest.mark.parametrize("case,b,s,moe", [
    ("prefill", 2, 12, {}),
    ("prefill, tokens dropped", 2, 16, {"capacity_factor_eval": 0.5}),
    ("prefill, one long row", 1, 40, {}),
    ("decode, no-drop capacity", 5, 1, {}),
])
def test_moe_block_matches_jax(case, b, s, moe):
    jc, tc = _cfgs(**moe)
    jp, tp = _params(jc, 1)
    x = _x(np.random.default_rng(b * s), b, s, jc.d_model)
    jy, jaux = jblocks.moe_block(jp, jnp.asarray(x), jc, jblocks.LOCAL_CTX,
                                 train=False)
    ty, taux = tblocks.moe_block(tp, torch.from_numpy(x), tc,
                                 train=False)
    assert ty.shape == x.shape
    _close(ty, jy)
    _close(taux, jaux)
    dropped = _dropped(tc, tp, x)
    if "dropped" in case:
        assert dropped > 0
    if "decode" in case:
        assert dropped == 0


def test_moe_capacity_rule():
    _, tc = _cfgs()
    # decode: k slots a token rounded up to 8; prefill: eval factor 2.0
    assert tblocks.moe_capacity(tc, 5, 1) == 16
    assert tblocks.moe_capacity(tc, 1, 1) == 8
    assert tblocks.moe_capacity(tc, 64, 32) == 64
    assert tblocks.moe_capacity(tc, 9, 9) == 16
    full = tcfgs.resolve(ARCH)
    # the serve phase's largest prefill group (2 rows of the 512 bucket)
    # and its decode step (8 slots)
    assert tblocks.moe_capacity(full, 1024, 512) == 80
    assert tblocks.moe_capacity(full, 8, 1) == 48


def test_moe_block_without_shared_experts_matches_jax():
    jc, tc = _cfgs(num_shared_experts=0)
    jp, tp = _params(jc, 2)
    assert "shared" not in tp
    x = _x(np.random.default_rng(9), 2, 7, jc.d_model)
    jy, _ = jblocks.moe_block(jp, jnp.asarray(x), jc, jblocks.LOCAL_CTX,
                              train=False)
    ty, _ = tblocks.moe_block(tp, torch.from_numpy(x), tc, train=False)
    _close(ty, jy)
