"""Transformer building blocks of the dense path
(port of ``repro/models/blocks.py``).

Pure functions ``apply(params, x, ...)`` over plain dicts of tensors.
Weights keep the JAX ``(in, out)`` layout and are applied as ``x @ W``;
they are cast to ``cfg.compute_dtype`` at use (a no-op when the caller
already holds them in that dtype). Single device: the JAX
``ParallelCtx``/``constrain`` sharding hooks have no counterpart here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as attn_ops


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _cast(x: torch.Tensor, dtype_str: str) -> torch.Tensor:
    return x.to(dtype_of(dtype_str))


# --------------------------------------------------------------------------
# initializers (same shapes and scales as the JAX package; torch's
# generator gives other numbers than jax.random for the same seed)
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, fan_in: Optional[int] = None
               ) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * (1.0 / math.sqrt(fan))).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * 0.02).to(dtype)


def init_norm(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg.param_dtype)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones((cfg.d_model,), dtype=dt,
                                    device=gen.device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((cfg.d_model,), dtype=dt,
                                    device=gen.device),
                "bias": torch.zeros((cfg.d_model,), dtype=dt,
                                    device=gen.device)}
    if cfg.norm == "nonparam_ln":        # OLMo: no affine params
        return {}
    raise ValueError(cfg.norm)


def init_attention(cfg: ModelConfig, gen: torch.Generator
                   ) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg.param_dtype)
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (d, h * dh), dt),
        "wk": dense_init(gen, (d, hkv * dh), dt),
        "wv": dense_init(gen, (d, hkv * dh), dt),
        "wo": dense_init(gen, (h * dh, d), dt, fan_in=h * dh),
    }


def init_mlp(cfg: ModelConfig, gen: torch.Generator
             ) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg.param_dtype)
    d, ff = cfg.d_model, cfg.d_ff
    return {"w_gate": dense_init(gen, (d, ff), dt),
            "w_up": dense_init(gen, (d, ff), dt),
            "w_down": dense_init(gen, (ff, d), dt, fan_in=ff)}


# --------------------------------------------------------------------------
# norm, RoPE
# --------------------------------------------------------------------------


def apply_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, LayerNorm or OLMo's non-parametric LayerNorm, in fp32
    (biased variance), cast back to x's dtype."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                              + eps)
        xf = xf * params["scale"].float()
    elif cfg.norm in ("layernorm", "nonparam_ln"):
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        if params:
            xf = xf * params["scale"].float()
            if "bias" in params:
                xf = xf + params["bias"].float()
    else:
        raise ValueError(f"norm '{cfg.norm}' is not ported yet")
    return xf.to(x.dtype)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, D) with positions (S,) or (B, S); rotate-half."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)      # (D/2,)
    if positions.ndim == 1:
        ang = positions[:, None].float() * freqs[None, :]
        ang = ang[None, :, None, :]                    # (1, S, 1, D/2)
    else:
        ang = positions[..., None].float() * freqs
        ang = ang[:, :, None, :]                       # (B, S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention, MLP
# --------------------------------------------------------------------------


def attention_qkv(params, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor):
    """Project to rotated q, k and v, each (B, S, heads, Dh)."""
    if cfg.qk_norm:
        raise ValueError("qk_norm is not ported yet")
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cdt = dtype_of(cfg.compute_dtype)
    q = (x @ _cast(params["wq"], cfg.compute_dtype)).reshape(b, s, h, dh)
    k = (x @ _cast(params["wk"], cfg.compute_dtype)).reshape(b, s, hkv, dh)
    v = (x @ _cast(params["wv"], cfg.compute_dtype)).reshape(b, s, hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.to(cdt), k.to(cdt), v.to(cdt)


def attention_block(params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, q_offset: int = 0,
                    return_kv: bool = False):
    """Full-sequence causal attention (prefill and training). A single
    position takes the dense path, as in the JAX package. With
    ``attention_impl="kernel"`` and a gradient wanted, the op is the
    differentiable ``FlashAttentionFn`` (forward and backward kernels)."""
    b, s, _ = x.shape
    q, k, v = attention_qkv(params, x, cfg, positions)
    out = attn_ops.flash_attention(
        q, k, v, causal=True, q_offset=q_offset,
        impl=cfg.attention_impl if s > 1 else "dense")
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    y = out @ _cast(params["wo"], cfg.compute_dtype)
    if return_kv:
        return y, (k, v)
    return y


def mlp_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU feed-forward: (silu(x Wg) * x Wu) Wd."""
    if cfg.activation != "swiglu":
        raise ValueError(f"activation '{cfg.activation}' is not ported yet "
                         f"(swiglu only)")
    cdt = cfg.compute_dtype
    g = x @ _cast(params["w_gate"], cdt)
    u = x @ _cast(params["w_up"], cdt)
    return (F.silu(g) * u) @ _cast(params["w_down"], cdt)
