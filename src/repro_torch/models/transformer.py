"""Decoder stack for the uniform plan (dense, MoE and MLA layers;
port of ``repro/models/transformer.py``).

Parameters are a plain dict: ``embed`` (V, d), ``final_norm``,
``lm_head`` (d, V; absent with tied embeddings, where the head is
``embed`` transposed) and ``layers``, a list with one dict per layer
(``ln1``, ``attn``, ``ln2`` and ``mlp`` or ``moe``; ``attn`` holds the
MLA projections on an MLA config). Norm dicts are empty for OLMo's
non-parametric LayerNorm. The JAX package stacks the layers along a
leading axis for ``lax.scan``; here the stack is a Python loop, each
layer under ``torch.utils.checkpoint`` when ``remat="full"``. MoE and
MLA layers are ported for serving (prefill and paged decode) only;
:func:`check_supported` names what a config may not use yet,
:func:`check_servable` what serving may not.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIM, PREFILL_HEAD_DIMS)
from repro_torch.kernels.mla_decode.mla_decode import RANK, ROPE_DIM
from repro_torch.models.blocks import (_cast, apply_norm, attention_block,
                                       dtype_of, embed_init, dense_init,
                                       init_attention, init_mla, init_mlp,
                                       init_moe, init_norm, mla_block,
                                       mlp_block, moe_block)
from repro_torch.models.kvcache import (PagedLayout, attention_decode_paged,
                                        decode_write_index,
                                        init_gqa_paged_cache,
                                        init_mla_paged_cache,
                                        mla_decode_paged)


def check_supported(cfg: ModelConfig, serving: bool = False) -> None:
    """Raise for any config feature outside this port. MoE and MLA
    layers pass only with ``serving`` (prefill and paged decode): their
    training (the MoE aux loss, the MLA backward) is not ported yet."""
    unsupported = [
        (cfg.moe.enabled and not serving, "MoE training"),
        (cfg.mla.enabled and not serving, "MLA training"),
        (cfg.moe.dense_residual, "MoE dense_residual"),
        (cfg.ssm.enabled, "SSM"), (cfg.xlstm.enabled, "xLSTM"),
        (cfg.hybrid.enabled, "hybrid"), (cfg.qk_norm, "qk_norm"),
        (cfg.frontend != "token", f"frontend '{cfg.frontend}'"),
        (cfg.norm not in ("rmsnorm", "layernorm", "nonparam_ln"),
         f"norm '{cfg.norm}'"),
        (cfg.activation != "swiglu", f"activation '{cfg.activation}'"),
    ]
    missing = [name for bad, name in unsupported if bad]
    if missing:
        raise ValueError(f"{cfg.name}: {', '.join(missing)} not ported to "
                         f"repro_torch yet (uniform plan: dense layers, "
                         f"and MoE/MLA layers for serving)")


def check_servable(cfg: ModelConfig, device) -> None:
    """``check_supported(serving=True)`` plus what the serving kernels
    cannot take on the card: the GQA paged-decode kernel is built for
    head_dim 64, the MLA decode kernels for latent rank 512 and RoPE
    width 64, the prefill kernel for head dims 64, 128 and 192 (on the
    CPU the kernels' plain versions take any width)."""
    check_supported(cfg, serving=True)
    if (cfg.attention_impl != "kernel"
            or torch.device(device).type != "cuda"):
        return
    if cfg.mla.enabled:
        m = cfg.mla
        dqk = m.nope_head_dim + m.rope_head_dim
        if ((m.kv_lora_rank, m.rope_head_dim) != (RANK, ROPE_DIM)
                or dqk not in PREFILL_HEAD_DIMS):
            raise ValueError(
                f"{cfg.name}: serving MLA with attention_impl='kernel' "
                f"needs kv_lora_rank {RANK}, rope_head_dim {ROPE_DIM} and "
                f"nope + rope in {PREFILL_HEAD_DIMS}, got "
                f"{m.kv_lora_rank}, {m.rope_head_dim}, {dqk}; not ported "
                f"yet")
    elif cfg.head_dim != HEAD_DIM:
        raise ValueError(
            f"{cfg.name}: serving with attention_impl='kernel' needs "
            f"head_dim {HEAD_DIM} (the paged-decode kernel's), got "
            f"{cfg.head_dim}; serving at head_dim {cfg.head_dim} is not "
            f"ported yet")


def init_params(cfg: ModelConfig, seed: int, device) -> Dict[str, Any]:
    """Random parameters with the JAX package's shapes and init scales,
    drawn from a ``torch.Generator`` on ``device``."""
    check_supported(cfg, serving=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dt = dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "final_norm": init_norm(cfg, gen),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dt)
    params["layers"] = [init_uniform_layer(cfg, gen)
                        for _ in range(cfg.num_layers)]
    return params


def init_uniform_layer(cfg: ModelConfig, gen: torch.Generator
                       ) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "ln1": init_norm(cfg, gen),
        "attn": (init_mla(cfg, gen) if cfg.mla.enabled
                 else init_attention(cfg, gen)),
        "ln2": init_norm(cfg, gen)}
    if cfg.moe.enabled:
        p["moe"] = init_moe(cfg, gen)
    else:
        p["mlp"] = init_mlp(cfg, gen)
    return p


def count_params_analytic(cfg: ModelConfig) -> int:
    """Parameters of ``init_params(cfg)``, from the widths alone."""
    d, dh, h = cfg.d_model, cfg.head_dim, cfg.num_heads
    norm = {"rmsnorm": d, "layernorm": 2 * d, "nonparam_ln": 0}[cfg.norm]
    if cfg.mla.enabled:
        m = cfg.mla
        qd = m.nope_head_dim + m.rope_head_dim
        attn = (d * m.kv_lora_rank + m.kv_lora_rank + d * m.rope_head_dim
                + m.kv_lora_rank * h * (m.nope_head_dim + m.v_head_dim)
                + h * m.v_head_dim * d)
        attn += (d * m.q_lora_rank + m.q_lora_rank + m.q_lora_rank * h * qd
                 if m.q_lora_rank > 0 else d * h * qd)
    else:
        attn = d * dh * (h * 2 + cfg.num_kv_heads * 2)
    if cfg.moe.enabled:
        mo = cfg.moe
        ffn = (d * mo.num_experts + 3 * mo.num_experts * d * mo.expert_d_ff
               + 3 * d * mo.shared_d_ff * mo.num_shared_experts)
    else:
        ffn = 3 * d * cfg.d_ff
    layer = 2 * norm + attn + ffn
    head = 0 if cfg.tie_embeddings else d * cfg.vocab_size
    return cfg.vocab_size * d + norm + head + cfg.num_layers * layer


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Tensors of a parameter tree in a fixed order (dict insertion
    order, then list order); empty norm dicts contribute nothing."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over matching leaves of trees with one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def cast_params(params: Any, dtype: torch.dtype) -> Any:
    """The same parameter tree with every tensor in ``dtype``: a serving
    copy in the compute dtype, so no step casts the weights again."""
    return tree_map(lambda p: p.to(dtype), params)


def embed_tokens(params, inputs: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Token ids (B, S) -> embeddings (B, S, d) in the compute dtype.
    ``F.embedding``: its backward sums repeated tokens deterministically
    on the card."""
    return F.embedding(inputs.long(), params["embed"]).to(
        dtype_of(cfg.compute_dtype))


def lm_head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    """The (d, V) head in the compute dtype: ``embed`` transposed (a
    view) when tied. With tied weights the gradient reaches ``embed``
    through both this and the gather of :func:`embed_tokens`, and
    autograd sums the two into the one leaf, as JAX does."""
    if cfg.tie_embeddings:
        return _cast(params["embed"], cfg.compute_dtype).t()
    return _cast(params["lm_head"], cfg.compute_dtype)


def unembed(params, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """hidden (..., d) -> logits (..., V), soft-capped if configured."""
    logits = hidden @ lm_head_matrix(params, cfg)
    if cfg.logit_softcap > 0.0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def apply_uniform_layer(p, x: torch.Tensor, cfg: ModelConfig,
                        positions: torch.Tensor) -> torch.Tensor:
    """One pre-norm decoder layer: attention then SwiGLU, residual."""
    x = x + attention_block(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                            positions)
    return x + mlp_block(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)


def hidden_states(params, embeds: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """embeds (B, S, d) -> (final-normed hidden (B, S, d), aux loss 0).

    ``cfg.remat``: "full" runs each layer under a non-reentrant
    checkpoint (only the layer input is kept; the backward recomputes
    the layer, attention kernel included), "none" keeps every
    activation; "dots" (save matmul outputs only) is not ported yet."""
    check_supported(cfg)
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"remat '{cfg.remat}' is not ported yet "
                         f"(none | full)")
    positions = torch.arange(embeds.shape[1], device=embeds.device)
    x = embeds
    for lp in params["layers"]:
        if cfg.remat == "full" and torch.is_grad_enabled():
            x = checkpoint(apply_uniform_layer, lp, x, cfg, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = apply_uniform_layer(lp, x, cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=embeds.device)
    return apply_norm(params["final_norm"], x, cfg), aux


def _ffn_serving(p, h2: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The layer's feed-forward on the serving path: the MoE block at the
    eval capacity (its aux loss dropped) or the dense MLP."""
    if "moe" in p:
        return moe_block(p["moe"], h2, cfg)[0]
    return mlp_block(p["mlp"], h2, cfg)


def _layer_prefill(p, x, cfg, positions):
    h = apply_norm(p["ln1"], x, cfg)
    block = mla_block if cfg.mla.enabled else attention_block
    a, kv = block(p["attn"], h, cfg, positions, return_kv=True)
    x = x + a
    return x + _ffn_serving(p, apply_norm(p["ln2"], x, cfg), cfg), kv


def cache_names(cfg: ModelConfig) -> Tuple[str, str]:
    """The two cache tensors of a layer: the MLA latent and RoPE key, or
    GQA's k and v."""
    return ("c_kv", "k_rope") if cfg.mla.enabled else ("k", "v")


def prefill(params, embeds: torch.Tensor, cfg: ModelConfig,
            max_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (hidden (B, S, d), cache): {"k","v"} (L, B, max_len, Hkv,
    Dh), or for MLA {"c_kv"} (L, B, max_len, r) and {"k_rope"} (L, B,
    max_len, Dr); positions past S are zeros."""
    b, s, _ = embeds.shape
    positions = torch.arange(s, device=embeds.device)
    x = embeds
    kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for lp in params["layers"]:
        x, kv = _layer_prefill(lp, x, cfg, positions)
        kvs.append(kv)
    pad = max_len - s

    def stack(parts):
        out = torch.stack(parts)
        if pad:
            out = F.pad(out, (0, 0) * (out.ndim - 3) + (0, pad))
        return out

    return (apply_norm(params["final_norm"], x, cfg),
            {name: stack([kv[i] for kv in kvs])
             for i, name in enumerate(cache_names(cfg))})


def init_paged_cache(cfg: ModelConfig, layout: PagedLayout, device
                     ) -> Dict[str, torch.Tensor]:
    """Zero paged block pool for the uniform attention stack."""
    check_servable(cfg, device)
    init = init_mla_paged_cache if cfg.mla.enabled else init_gqa_paged_cache
    return init(cfg, cfg.num_layers, layout, device)


def decode_step_paged(params, embeds: torch.Tensor, cfg: ModelConfig,
                      cache: Dict[str, torch.Tensor],
                      block_tables: torch.Tensor, kv_lens: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token per sequence against the paged pool (updated in place).

    embeds (B, 1, d); block_tables (B, MB) int32; kv_lens (B,) int32.
    Returns (hidden (B, 1, d), cache).
    """
    first, second = cache_names(cfg)
    n, bs = cache[first].shape[1:3]
    where = decode_write_index(block_tables, kv_lens, bs, n)
    decode = mla_decode_paged if cfg.mla.enabled else attention_decode_paged
    x = embeds
    for i, lp in enumerate(params["layers"]):
        h = apply_norm(lp["ln1"], x, cfg)
        a, _ = decode(lp["attn"], h, cfg, cache[first][i], cache[second][i],
                      block_tables, kv_lens, write_index=where)
        x = x + a
        x = x + _ffn_serving(lp, apply_norm(lp["ln2"], x, cfg), cfg)
    return apply_norm(params["final_norm"], x, cfg), cache
