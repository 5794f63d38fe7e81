"""repro_torch dense blocks against the JAX package, at fp32 on the
tinyllama smoke widths: RMSNorm, LayerNorm, OLMo's non-parametric
LayerNorm, RoPE with 1-D (prefill) and 2-D
(per-sequence decode) positions, the GQA q/k/v projection and the
SwiGLU MLP. Inputs and weights are numpy arrays from a seed, handed to
both packages. Tolerance 1e-5 absolute: the same arithmetic, summed in
another order by another backend."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.models import blocks as jblocks
from repro_torch.configs import base as tcfgs
from repro_torch.models import blocks as tblocks

TOL = 1e-5


def _cfgs():
    jc = dataclasses.replace(jcfgs.smoke_config("tinyllama-1.1b"),
                             compute_dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config("tinyllama-1.1b"),
                             compute_dtype="float32")
    return jc, tc


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=TOL, rtol=0)


def test_apply_norm_matches_jax():
    jc, tc = _cfgs()
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 7, jc.d_model))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, jc.d_model).astype(np.float32)
    _close(tblocks.apply_norm({"scale": torch.from_numpy(scale)},
                              torch.from_numpy(x), tc),
           jblocks.apply_norm({"scale": jnp.asarray(scale)},
                              jnp.asarray(x), jc))


@pytest.mark.parametrize("norm", ["layernorm", "nonparam_ln"])
def test_layernorm_and_nonparam_ln_match_jax(norm):
    """LayerNorm with scale and bias, and OLMo's non-parametric LayerNorm
    (no params: an empty dict on both sides), fp32 with eps 1e-5 and the
    biased variance."""
    jc, tc = (dataclasses.replace(c, norm=norm) for c in _cfgs())
    rng = np.random.default_rng(4)
    x = (3.0 * rng.standard_normal((2, 7, jc.d_model)) + 1.5).astype(
        np.float32)
    p = {}
    if norm == "layernorm":
        p = {"scale": rng.uniform(0.5, 1.5, jc.d_model).astype(np.float32),
             "bias": rng.standard_normal(jc.d_model).astype(np.float32)}
    tp = tblocks.init_norm(tc, torch.Generator().manual_seed(0))
    assert set(tp) == set(p)
    _close(tblocks.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), tc),
           jblocks.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jc))


@pytest.mark.parametrize("pos_kind", ["1d", "2d"])
def test_apply_rope_matches_jax(pos_kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    if pos_kind == "1d":
        pos = np.arange(5, dtype=np.int32) + 11
    else:
        pos = rng.integers(0, 4096, size=(3, 5)).astype(np.int32)
    _close(tblocks.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              10000.0),
           jblocks.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


def _attn_params(cfg, rng):
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
              "wo": (h * dh, d)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("pos_kind", ["1d", "2d"])
def test_attention_qkv_matches_jax(pos_kind):
    jc, tc = _cfgs()
    rng = np.random.default_rng(2)
    p = _attn_params(jc, rng)
    s = 6 if pos_kind == "1d" else 1
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    pos = (np.arange(s, dtype=np.int32) if pos_kind == "1d"
           else np.array([[3], [40]], np.int32))
    tq = tblocks.attention_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), tc, torch.from_numpy(pos))
    jq = jblocks.attention_qkv({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), jc, jnp.asarray(pos))
    for t, j in zip(tq, jq):
        assert tuple(t.shape) == j.shape
        _close(t, j)


def test_swiglu_mlp_matches_jax():
    jc, tc = _cfgs()
    rng = np.random.default_rng(3)
    d, ff = jc.d_model, jc.d_ff
    p = {"w_gate": rng.standard_normal((d, ff)) / np.sqrt(d),
         "w_up": rng.standard_normal((d, ff)) / np.sqrt(d),
         "w_down": rng.standard_normal((ff, d)) / np.sqrt(ff)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    _close(tblocks.mlp_block({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), tc),
           jblocks.mlp_block({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jc, jblocks.LOCAL_CTX))


def test_unported_block_options_raise():
    _, tc = _cfgs()
    x = torch.zeros((1, 2, tc.d_model))
    with pytest.raises(ValueError, match="not ported yet"):
        tblocks.apply_norm({}, x, dataclasses.replace(tc, norm="groupnorm"))
    with pytest.raises(ValueError, match="swiglu only"):
        tblocks.mlp_block({}, x, dataclasses.replace(tc, activation="gelu"))
