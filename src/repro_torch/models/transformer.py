"""Decoder stack for the uniform dense plan
(port of ``repro/models/transformer.py``).

Parameters are a plain dict: ``embed`` (V, d), ``final_norm``,
``lm_head`` (d, V) and ``layers``, a list with one dict per layer
(``ln1``, ``attn``, ``ln2``, ``mlp``). The JAX package stacks the layers
along a leading axis for ``lax.scan``; here the stack is a Python loop.
Only the dense uniform plan is ported; :func:`check_supported` names
what a config may not use yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import (_cast, apply_norm, attention_block,
                                       dtype_of, embed_init, dense_init,
                                       init_attention, init_mlp, init_norm,
                                       mlp_block)
from repro_torch.models.kvcache import (PagedLayout, attention_decode_paged,
                                        decode_write_index,
                                        init_gqa_paged_cache)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any config feature outside this port's dense path."""
    unsupported = [
        (cfg.moe.enabled, "MoE"), (cfg.mla.enabled, "MLA"),
        (cfg.ssm.enabled, "SSM"), (cfg.xlstm.enabled, "xLSTM"),
        (cfg.hybrid.enabled, "hybrid"), (cfg.qk_norm, "qk_norm"),
        (cfg.tie_embeddings, "tied embeddings"),
        (cfg.frontend != "token", f"frontend '{cfg.frontend}'"),
        (cfg.norm != "rmsnorm", f"norm '{cfg.norm}'"),
        (cfg.activation != "swiglu", f"activation '{cfg.activation}'"),
        (cfg.logit_softcap != 0.0, "logit softcap"),
    ]
    missing = [name for bad, name in unsupported if bad]
    if missing:
        raise ValueError(f"{cfg.name}: {', '.join(missing)} not ported to "
                         f"repro_torch yet (dense uniform plan only)")


def init_params(cfg: ModelConfig, seed: int, device) -> Dict[str, Any]:
    """Random parameters with the JAX package's shapes and init scales,
    drawn from a ``torch.Generator`` on ``device``."""
    check_supported(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dt = dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "final_norm": init_norm(cfg, gen),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab_size), dt),
        "layers": [{"ln1": init_norm(cfg, gen),
                    "attn": init_attention(cfg, gen),
                    "ln2": init_norm(cfg, gen),
                    "mlp": init_mlp(cfg, gen)}
                   for _ in range(cfg.num_layers)],
    }
    return params


def cast_params(params: Any, dtype: torch.dtype) -> Any:
    """The same parameter tree with every tensor in ``dtype``: a serving
    copy in the compute dtype, so no step casts the weights again."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype)


def embed_tokens(params, inputs: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Token ids (B, S) -> embeddings (B, S, d) in the compute dtype."""
    return params["embed"][inputs.long()].to(dtype_of(cfg.compute_dtype))


def unembed(params, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """hidden (..., d) -> logits (..., V)."""
    return hidden @ _cast(params["lm_head"], cfg.compute_dtype)


def _layer_prefill(p, x, cfg, positions):
    h = apply_norm(p["ln1"], x, cfg)
    a, kv = attention_block(p["attn"], h, cfg, positions, return_kv=True)
    x = x + a
    x = x + mlp_block(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    return x, kv


def prefill(params, embeds: torch.Tensor, cfg: ModelConfig,
            max_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (hidden (B, S, d), cache {"k","v"}: (L, B, max_len, Hkv,
    Dh)); positions past S are zeros."""
    b, s, _ = embeds.shape
    positions = torch.arange(s, device=embeds.device)
    x = embeds
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for lp in params["layers"]:
        x, (k, v) = _layer_prefill(lp, x, cfg, positions)
        ks.append(k)
        vs.append(v)
    pad = max_len - s

    def stack(kv):
        out = torch.stack(kv)
        if pad:
            out = torch.nn.functional.pad(out, (0, 0, 0, 0, 0, pad))
        return out

    return (apply_norm(params["final_norm"], x, cfg),
            {"k": stack(ks), "v": stack(vs)})


def init_paged_cache(cfg: ModelConfig, layout: PagedLayout, device
                     ) -> Dict[str, torch.Tensor]:
    """Zero paged block pool for the uniform attention stack."""
    check_supported(cfg)
    return init_gqa_paged_cache(cfg, cfg.num_layers, layout, device)


def decode_step_paged(params, embeds: torch.Tensor, cfg: ModelConfig,
                      cache: Dict[str, torch.Tensor],
                      block_tables: torch.Tensor, kv_lens: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token per sequence against the paged pool (updated in place).

    embeds (B, 1, d); block_tables (B, MB) int32; kv_lens (B,) int32.
    Returns (hidden (B, 1, d), cache).
    """
    n, bs = cache["k"].shape[1:3]
    where = decode_write_index(block_tables, kv_lens, bs, n)
    x = embeds
    for i, lp in enumerate(params["layers"]):
        h = apply_norm(lp["ln1"], x, cfg)
        a, _ = attention_decode_paged(lp["attn"], h, cfg, cache["k"][i],
                                      cache["v"][i], block_tables, kv_lens,
                                      write_index=where)
        x = x + a
        x = x + mlp_block(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)
    return apply_norm(params["final_norm"], x, cfg), cache
