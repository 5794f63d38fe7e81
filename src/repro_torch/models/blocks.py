"""Transformer building blocks: norms (and Mamba2's gated RMSNorm), RoPE,
GQA attention (with optional QK-norm) and MLA attention, the MLP (SwiGLU,
GeGLU or GELU), MoE (port of ``repro/models/blocks.py``).

GELU is the tanh form (``F.gelu(..., approximate="tanh")``): the JAX
package's ``jax.nn.gelu`` defaults to ``approximate=True``, while
``F.gelu`` defaults to the erf form.

Pure functions ``apply(params, x, ...)`` over plain dicts of tensors.
Weights keep the JAX ``(in, out)`` layout and are applied as ``x @ W``;
they are cast to ``cfg.compute_dtype`` at use (a no-op when the caller
already holds them in that dtype). Single device: the JAX
``ParallelCtx``/``constrain`` sharding hooks have no counterpart here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

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
    """The draw scaled in place: one fp32 temporary a leaf (arctic's
    expert stacks are 17.8 GB each in fp32)."""
    fan = fan_in if fan_in is not None else shape[0]
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(1.0 / math.sqrt(fan)).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(0.02).to(dtype)


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
    p = {
        "wq": dense_init(gen, (d, h * dh), dt),
        "wk": dense_init(gen, (d, hkv * dh), dt),
        "wv": dense_init(gen, (d, hkv * dh), dt),
        "wo": dense_init(gen, (h * dh, d), dt, fan_in=h * dh),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.ones((dh,), dtype=dt, device=gen.device)
    return p


GATED = ("swiglu", "geglu")      # activations whose MLP has a gate


def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Gated (SwiGLU, GeGLU): ``w_gate``, ``w_up``, ``w_down``; GELU:
    ``w_up`` and ``w_down`` only, as in the JAX package."""
    dt = dtype_of(cfg.param_dtype)
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation in GATED:
        return {"w_gate": dense_init(gen, (d, ff), dt),
                "w_up": dense_init(gen, (d, ff), dt),
                "w_down": dense_init(gen, (ff, d), dt, fan_in=ff)}
    return {"w_up": dense_init(gen, (d, ff), dt),
            "w_down": dense_init(gen, (ff, d), dt, fan_in=ff)}


def mlp_param_count(cfg: ModelConfig, d_ff: int) -> int:
    """Parameters of :func:`init_mlp` at hidden width ``d_ff``."""
    return (3 if cfg.activation in GATED else 2) * cfg.d_model * d_ff


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


def rms_norm_gated(x: torch.Tensor, gate: torch.Tensor,
                   scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mamba2 gated RMSNorm: norm(x * silu(gate)) * scale, in fp32, cast
    back to x's dtype (eps 1e-5, not the MLA norms' 1e-6)."""
    xf = x.float() * F.silu(gate.float())
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


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
    """Project to rotated q, k and v, each (B, S, heads, Dh). With
    ``qk_norm`` q and k take an fp32 RMS norm over the head dim (eps
    1e-6, scales ``q_norm`` and ``k_norm``) before RoPE."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cdt = dtype_of(cfg.compute_dtype)
    q = (x @ _cast(params["wq"], cfg.compute_dtype)).reshape(b, s, h, dh)
    k = (x @ _cast(params["wk"], cfg.compute_dtype)).reshape(b, s, hkv, dh)
    v = (x @ _cast(params["wv"], cfg.compute_dtype)).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = _rms(q, params["q_norm"])
        k = _rms(k, params["k_norm"])
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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form."""
    return F.gelu(x, approximate="tanh")


def mlp_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Feed-forward: (act(x Wg) * x Wu) Wd with a gate (act silu for
    SwiGLU, GELU for GeGLU), gelu(x Wu) Wd without one."""
    cdt = cfg.compute_dtype
    if "w_gate" in params:
        g = x @ _cast(params["w_gate"], cdt)
        u = x @ _cast(params["w_up"], cdt)
        h = (F.silu(g) if cfg.activation == "swiglu" else gelu(g)) * u
    else:
        h = gelu(x @ _cast(params["w_up"], cdt))
    return h @ _cast(params["w_down"], cdt)


# --------------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# --------------------------------------------------------------------------


def init_mla(cfg: ModelConfig, gen: torch.Generator
             ) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg.param_dtype)
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qd = m.nope_head_dim + m.rope_head_dim
    p = {
        "w_dkv": dense_init(gen, (d, m.kv_lora_rank), dt),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dt,
                              device=gen.device),
        "w_kr": dense_init(gen, (d, m.rope_head_dim), dt),
        "w_uk": dense_init(gen, (m.kv_lora_rank, h * m.nope_head_dim), dt),
        "w_uv": dense_init(gen, (m.kv_lora_rank, h * m.v_head_dim), dt),
        "wo": dense_init(gen, (h * m.v_head_dim, d), dt),
    }
    if m.q_lora_rank > 0:
        p["w_dq"] = dense_init(gen, (d, m.q_lora_rank), dt)
        p["q_norm"] = torch.ones((m.q_lora_rank,), dtype=dt,
                                 device=gen.device)
        p["w_uq"] = dense_init(gen, (m.q_lora_rank, h * qd), dt)
    else:
        p["wq"] = dense_init(gen, (d, h * qd), dt)
    return p


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
         ) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def mla_queries(params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q split into (q_nope (B,S,H,dn), q_rope (B,S,H,dr))."""
    b, s, _ = x.shape
    m, h = cfg.mla, cfg.num_heads
    qd = m.nope_head_dim + m.rope_head_dim
    cdt = cfg.compute_dtype
    if m.q_lora_rank > 0:
        ql = _rms(x @ _cast(params["w_dq"], cdt), params["q_norm"])
        q = (ql @ _cast(params["w_uq"], cdt)).reshape(b, s, h, qd)
    else:
        q = (x @ _cast(params["wq"], cdt)).reshape(b, s, h, qd)
    q_nope = q[..., :m.nope_head_dim]
    q_rope = apply_rope(q[..., m.nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_latent(params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed KV latent: (c_kv (B,S,r), k_rope (B,S,dr))."""
    cdt = cfg.compute_dtype
    c_kv = _rms(x @ _cast(params["w_dkv"], cdt), params["kv_norm"])
    k_r = x @ _cast(params["w_kr"], cdt)
    k_r = apply_rope(k_r[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_r


def mla_block(params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, return_kv: bool = False):
    """Prefill MLA: decompress per-head k/v and run causal attention.
    v is zero-padded to the qk head dim (nope + rope) so the attention
    sees one head dim, and sliced back after. With ``return_kv`` also
    returns the compressed latent (c_kv, k_rope) for the cache."""
    b, s, _ = x.shape
    m, h = cfg.mla, cfg.num_heads
    cdt = cfg.compute_dtype
    q_nope, q_rope = mla_queries(params, x, cfg, positions)
    c_kv, k_r = mla_latent(params, x, cfg, positions)
    k_nope = (c_kv @ _cast(params["w_uk"], cdt)).reshape(
        b, s, h, m.nope_head_dim)
    v = (c_kv @ _cast(params["w_uv"], cdt)).reshape(b, s, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_r[:, :, None, :].expand(
        b, s, h, m.rope_head_dim)], dim=-1)
    dqk = m.nope_head_dim + m.rope_head_dim
    if m.v_head_dim < dqk:
        v = F.pad(v, (0, dqk - m.v_head_dim))
    out = attn_ops.flash_attention(
        q, k, v, causal=True, softmax_scale=dqk ** -0.5,
        impl=cfg.attention_impl if s > 1 else "dense")
    out = out[..., :m.v_head_dim].reshape(b, s, h * m.v_head_dim)
    y = out @ _cast(params["wo"], cdt)
    if return_kv:
        return y, (c_kv, k_r)
    return y


# --------------------------------------------------------------------------
# Mixture of Experts (GShard-style top-k, capacity dispatch), one device
# --------------------------------------------------------------------------


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, object]:
    dt = dtype_of(cfg.param_dtype)
    mo = cfg.moe
    d, e, ff = cfg.d_model, mo.num_experts, mo.expert_d_ff
    p: Dict[str, object] = {
        "router": dense_init(gen, (d, e), dt),
        "w_gate": dense_init(gen, (e, d, ff), dt, fan_in=d),
        "w_up": dense_init(gen, (e, d, ff), dt, fan_in=d),
        "w_down": dense_init(gen, (e, ff, d), dt, fan_in=ff),
    }
    if mo.num_shared_experts > 0:
        p["shared"] = init_mlp(cfg, gen,
                               d_ff=mo.shared_d_ff * mo.num_shared_experts)
    return p


def _router(params, x2d: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. Returns (gates (T,k) fp32, eidx (T,k) int64,
    aux_loss). The logits are the fp32 product of the inputs and the
    router in x2d's dtype (exact products, fp32 sums, as the JAX
    ``preferred_element_type`` dot)."""
    mo = cfg.moe
    logits = x2d.float() @ params["router"].to(x2d.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, mo.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    ce = F.one_hot(eidx[:, 0], mo.num_experts).float().mean(dim=0)
    aux = mo.num_experts * torch.sum(me * ce) * mo.aux_loss_coef
    return gates, eidx, aux


def _moe_compute_local(x2d: torch.Tensor, gates: torch.Tensor,
                       eidx: torch.Tensor, w_gate, w_up, w_down,
                       capacity: int, cfg: ModelConfig) -> torch.Tensor:
    """Dispatch tokens to all E experts (each local: the JAX package's
    expert-parallel range is not ported), compute, combine. x2d (T, d);
    gates/eidx (T, k). Each (token, slot) takes the next place of its
    expert's queue in token-major order (an exclusive prefix count);
    places at or past ``capacity`` are dropped. The JAX ``mode="drop"``
    scatter becomes a write to a spare row ``capacity`` of the buffer
    that is cut off before the experts run, and the ``mode="fill"``
    gather a mask over the kept slots: neither asks the host which
    slots were kept."""
    t, d = x2d.shape
    k = eidx.shape[1]
    e = w_gate.shape[0]
    flat_e = eidx.reshape(-1)                          # (T*k,) token-major
    onehot = F.one_hot(flat_e, e)
    pos = torch.cumsum(onehot, dim=0) - onehot         # exclusive count
    pos_in_e = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = (pos_in_e < capacity).reshape(t, k)
    slot_e = flat_e.reshape(t, k)
    slot_c = torch.where(keep, pos_in_e.reshape(t, k), capacity)
    buf = torch.zeros((e, capacity + 1, d), dtype=x2d.dtype,
                      device=x2d.device)
    for j in range(k):
        buf[slot_e[:, j], slot_c[:, j]] = x2d
    buf = buf[:, :capacity]
    cdt = cfg.compute_dtype
    g = torch.einsum("ecd,edf->ecf", buf, _cast(w_gate, cdt))
    u = torch.einsum("ecd,edf->ecf", buf, _cast(w_up, cdt))
    act = F.silu(g) if cfg.activation == "swiglu" else gelu(g)
    eo = torch.einsum("ecf,efd->ecd", act * u, _cast(w_down, cdt))
    y = torch.zeros((t, d), dtype=eo.dtype, device=eo.device)
    for j in range(k):
        got = eo[slot_e[:, j], torch.clamp(slot_c[:, j], max=capacity - 1)]
        got = torch.where(keep[:, j, None], got, 0.0)
        y = y + got * gates[:, j].to(eo.dtype)[:, None]
    return y


def moe_capacity(cfg: ModelConfig, tokens: int, seq_len: int,
                 train: bool = False) -> int:
    """The expert capacity of a call over ``tokens`` tokens (a multiple
    of 8, at least 8): ``ceil(tokens * top_k * factor / E)`` with the
    training factor under ``train``, else the eval factor, and for a
    single-token decode (``seq_len == 1``, not ``train``) the exact
    no-drop capacity (the JAX ``moe_block``'s ``capacity_for``)."""
    mo = cfg.moe
    if not train and seq_len == 1:
        return max(8, -(-tokens * mo.top_k // 8) * 8)
    cf = mo.capacity_factor if train else mo.capacity_factor_eval
    cap = int(math.ceil(tokens * mo.top_k * cf / mo.num_experts))
    return max(8, -(-cap // 8) * 8)


def moe_block(params, x: torch.Tensor, cfg: ModelConfig,
              train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss) for x (B, S, d): routed experts plus the
    shared experts, as the JAX ``moe_block`` on one device. ``train``
    (the default, as in the JAX package) takes the training capacity
    over the call's B * S tokens, dummy rows included; ``train=False``
    (prefill and decode) the eval capacity. Under autograd the gradient
    reaches the router through the gates and, through ``probs``, the
    aux loss; a dropped (token, slot) takes no expert gradient. The
    expert-parallel branch is not ported (all experts are local)."""
    mo = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, eidx, aux = _router(params, x2d, cfg)
    y = _moe_compute_local(
        x2d, gates.to(x.dtype), eidx, params["w_gate"], params["w_up"],
        params["w_down"], moe_capacity(cfg, b * s, s, train), cfg)
    out = y.reshape(b, s, d)
    if mo.num_shared_experts > 0:
        out = out + mlp_block(params["shared"], x, cfg)
    return out, aux
