"""Decoder stacks (port of ``repro/models/transformer.py``).

Stack plans (:func:`stack_plan`, from the config):
  uniform — dense, MoE and MLA layers: identical (attention, ffn)
            layers;
  mamba   — a stack of Mamba2 layers;
  zamba   — the Mamba2 backbone with one weight-shared attention block
            (attention, then an MLP) applied after every
            ``hybrid.attn_every`` Mamba2 layers (zamba2);
  xlstm   — alternating mLSTM and sLSTM blocks, num_layers // 2 pairs
            (xlstm-125m).

Parameters are a plain dict: ``embed`` (V, d; the token frontend
only), ``final_norm``, ``lm_head`` (d, V; absent with tied embeddings
on the token frontend, where the head is ``embed`` transposed) and
``layers``, a list with one dict per layer: ``ln1``, ``attn``, ``ln2``
and ``mlp`` or ``moe`` on the uniform plan (``attn`` holds the MLA
projections on an MLA config, and ``q_norm``/``k_norm`` with QK-norm;
an Arctic-style MoE layer adds ``dense``, the dense residual MLP run
beside the experts), ``ln`` and
``mamba`` on the mamba and zamba plans; the zamba plan adds
``shared_attn`` (``ln1``, ``attn``, ``ln2``, ``mlp``), ONE dict applied
``num_layers // attn_every`` times, each application with its own KV
cache. The xlstm plan has no ``layers``: ``mlstm_layers`` and
``slstm_layers`` are lists of num_layers // 2 dicts ``{"ln", "blk"}``,
pair p running mLSTM block p then sLSTM block p. Norm dicts are empty
for OLMo's non-parametric LayerNorm. The JAX package stacks the layers
along a leading axis for ``lax.scan`` (for zamba an outer scan over
groups and an inner one over a group's layers; for xlstm one scan over
the pairs); here the stacks are Python loops under
``torch.utils.checkpoint`` when ``remat="full"``: each uniform or Mamba2
layer, each zamba group (its ``attn_every`` Mamba2 layers and the shared
block after them), each xlstm pair (its mLSTM block, then its sLSTM
block), as the JAX package's ``jax.checkpoint`` wraps each scan body.

Serving runs two cache families: the paged pool (:func:`prefill`, then
:func:`decode_step_paged`; the uniform plan only, as in the JAX
package) and the contiguous cache of static-batch serving
(:func:`prefill`, :func:`init_cache`, :func:`decode_step`; every
plan). Every plan trains: the uniform plan (dense, MoE and MLA
layers), the Mamba2, zamba and xLSTM stacks;
:func:`check_supported` names what a config may not use yet,
:func:`check_servable` what serving may not. The embedding-stub
frontend (chameleon, musicgen) takes precomputed embeddings (B, S, d)
in place of token ids, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.flash_attention import (
    DECODE_HEAD_DIMS, PREFILL_HEAD_DIMS)
from repro_torch.kernels.mla_decode.mla_decode import RANK, ROPE_DIM
from repro_torch.kernels.mlstm_scan.mlstm_scan import MAX_DK, WIDTH_MULT
from repro_torch.kernels.ssd_scan.ssd_scan import (MAX_CHUNK, P_SLICE,
                                                   STATE_DIM)
from repro_torch.models.blocks import (_cast, apply_norm, attention_block,
                                       dtype_of, embed_init, dense_init,
                                       init_attention, init_mla, init_mlp,
                                       init_moe, init_norm, mla_block,
                                       mlp_block, mlp_param_count,
                                       moe_block)
from repro_torch.models.kvcache import (PagedLayout, attention_decode,
                                        attention_decode_paged,
                                        decode_write_index, init_gqa_cache,
                                        init_gqa_paged_cache, init_mla_cache,
                                        init_mla_paged_cache, mla_decode,
                                        mla_decode_paged)
from repro_torch.models.ssm import (init_mamba, mamba_block,
                                    mamba_decode_step, mamba_dims)
from repro_torch.models.xlstm import (init_mlstm_block, init_mlstm_state,
                                      init_slstm_block, init_slstm_state,
                                      mlstm_block, mlstm_block_decode,
                                      mlstm_dims, slstm_block,
                                      slstm_block_decode, slstm_ff)


def stack_plan(cfg: ModelConfig) -> str:
    if cfg.xlstm.enabled:
        return "xlstm"
    if cfg.hybrid.enabled:
        return "zamba"
    if cfg.ssm.enabled:
        return "mamba"
    return "uniform"


def check_supported(cfg: ModelConfig, serving: bool = False) -> None:
    """Raise for any config feature outside this port. Dense, MoE and
    MLA layers (the uniform plan), Mamba2 stacks, zamba hybrids and
    xLSTM stacks train and serve; ``serving`` asks nothing more."""
    unsupported = [
        (cfg.hybrid.enabled and not cfg.ssm.enabled,
         "hybrid without an SSM"),
        (cfg.frontend not in ("token", "embedding_stub"),
         f"frontend '{cfg.frontend}'"),
        (cfg.norm not in ("rmsnorm", "layernorm", "nonparam_ln"),
         f"norm '{cfg.norm}'"),
        (cfg.activation not in ("swiglu", "geglu", "gelu"),
         f"activation '{cfg.activation}'"),
    ]
    missing = [name for bad, name in unsupported if bad]
    if missing:
        raise ValueError(f"{cfg.name}: {', '.join(missing)} not ported to "
                         f"repro_torch yet (dense, MoE, MLA, Mamba2, "
                         f"zamba and xLSTM stacks)")


def supports_staged_backward(cfg: ModelConfig) -> bool:
    """``overlap="backward"`` flushes gradient buckets as the backward
    lands them over the uniform stack (dense, MoE, MLA), as in the JAX
    package; the stack is a Python loop here, so ``scan_layers=False``
    needs nothing more. The Mamba2, zamba and xLSTM stacks are refused,
    as the JAX package's ``validate_train_config`` refuses them (and
    pipeline stages with them)."""
    return stack_plan(cfg) == "uniform"


def head_param_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """Top-level parameter keys whose gradients land at backward stage
    0 (the head): stage 0 is the head, stage s layer L-s, stage L+1 the
    embedding table (a tied table also takes a head-stage contribution,
    so it is final only at L+1)."""
    if tied_head(cfg):
        return ("final_norm", "embed")
    return ("final_norm", "lm_head")


def check_paged(cfg: ModelConfig) -> None:
    """The paged pool holds the uniform attention stack only (recurrent
    plans keep O(1) state per sequence: nothing to page), as in the
    JAX package."""
    plan = stack_plan(cfg)
    if plan != "uniform":
        raise ValueError(
            f"paged KV cache supports the uniform attention stack only, "
            f"got stack plan {plan!r}")


def check_servable(cfg: ModelConfig, device, paged: bool = True) -> None:
    """``check_supported(serving=True)`` plus what the serving kernels
    cannot take on the card: the GQA paged-decode kernel (``paged``) is
    built for head dims 64 and 128, the MLA decode kernels (the paged one, and
    with ``paged=False`` the contiguous one) for latent rank 512 and RoPE
    width 64, the prefill kernel for head dims 64, 80, 128 and 192, the
    SSD kernel for state dim 64, a head dim that is a multiple of 32 and
    chunks of at most 256, the mLSTM kernel for a head dim (d_inner /
    heads) that is a multiple of 64 and at most 512 (on the CPU the
    kernels' plain versions take any width)."""
    check_supported(cfg, serving=True)
    if (cfg.attention_impl != "kernel"
            or torch.device(device).type != "cuda"):
        return
    plan = stack_plan(cfg)
    if plan == "xlstm":
        dk = mlstm_dims(cfg)[2]
        if dk % WIDTH_MULT or dk > MAX_DK:
            raise ValueError(
                f"{cfg.name}: the mLSTM kernel (attention_impl='kernel') "
                f"needs a head dim (d_inner / heads) that is a multiple of "
                f"{WIDTH_MULT} and at most {MAX_DK}, got {dk}; not ported "
                f"yet")
        return
    if plan in ("mamba", "zamba"):
        s = cfg.ssm
        if (s.state_dim != STATE_DIM or s.head_dim % P_SLICE
                or s.chunk_size > MAX_CHUNK):
            raise ValueError(
                f"{cfg.name}: the SSD kernel (attention_impl='kernel') "
                f"needs state_dim {STATE_DIM}, a head_dim that is a "
                f"multiple of {P_SLICE} and chunk_size <= {MAX_CHUNK}, got "
                f"{s.state_dim}, {s.head_dim}, {s.chunk_size}; not ported "
                f"yet")
        if plan == "zamba" and cfg.head_dim not in PREFILL_HEAD_DIMS:
            raise ValueError(
                f"{cfg.name}: the shared attention block's prefill "
                f"kernel needs head_dim in {PREFILL_HEAD_DIMS}, got "
                f"{cfg.head_dim}; not ported yet")
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
    elif paged and cfg.head_dim not in DECODE_HEAD_DIMS:
        raise ValueError(
            f"{cfg.name}: serving with attention_impl='kernel' needs "
            f"head_dim in {DECODE_HEAD_DIMS} (the paged-decode kernel's), "
            f"got {cfg.head_dim}; serving at head_dim {cfg.head_dim} is "
            f"not ported yet")
    elif cfg.head_dim not in PREFILL_HEAD_DIMS:
        raise ValueError(
            f"{cfg.name}: the prefill kernel (attention_impl='kernel') "
            f"needs head_dim in {PREFILL_HEAD_DIMS}, got {cfg.head_dim}; "
            f"not ported yet")


def init_params(cfg: ModelConfig, seed: int, device) -> Dict[str, Any]:
    """Random parameters with the JAX package's shapes and init scales,
    drawn from a ``torch.Generator`` on ``device``."""
    check_supported(cfg, serving=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dt = dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {}
    if cfg.frontend == "token":
        params["embed"] = embed_init(gen, (cfg.vocab_size, cfg.d_model), dt)
    params["final_norm"] = init_norm(cfg, gen)
    if not tied_head(cfg):
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dt)
    plan = stack_plan(cfg)
    if plan == "xlstm":
        pairs = cfg.num_layers // 2
        for name, init in (("mlstm_layers", init_mlstm_block),
                           ("slstm_layers", init_slstm_block)):
            params[name] = [{"ln": init_norm(cfg, gen),
                             "blk": init(cfg, gen)} for _ in range(pairs)]
        return params
    layer_init = init_uniform_layer if plan == "uniform" else \
        init_mamba_layer
    params["layers"] = [layer_init(cfg, gen) for _ in range(cfg.num_layers)]
    if plan == "zamba":
        params["shared_attn"] = init_shared_attn(cfg, gen)
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
        if cfg.moe.dense_residual:
            p["dense"] = init_mlp(cfg, gen, d_ff=cfg.d_ff)
    else:
        p["mlp"] = init_mlp(cfg, gen)
    return p


def tied_head(cfg: ModelConfig) -> bool:
    """Whether the head is the embedding table transposed: tied weights
    on the token frontend (a stub frontend has no table)."""
    return cfg.tie_embeddings and cfg.frontend == "token"


def init_mamba_layer(cfg: ModelConfig, gen: torch.Generator
                     ) -> Dict[str, Any]:
    return {"ln": init_norm(cfg, gen), "mamba": init_mamba(cfg, gen)}


def init_shared_attn(cfg: ModelConfig, gen: torch.Generator
                     ) -> Dict[str, Any]:
    p: Dict[str, Any] = {"ln1": init_norm(cfg, gen),
                         "attn": init_attention(cfg, gen)}
    if cfg.hybrid.shared_attn_d_ff > 0:
        p["ln2"] = init_norm(cfg, gen)
        p["mlp"] = init_mlp(cfg, gen, d_ff=cfg.hybrid.shared_attn_d_ff)
    return p


def count_params_analytic(cfg: ModelConfig) -> int:
    """Parameters of ``init_params(cfg)``, from the widths alone."""
    d, dh, h = cfg.d_model, cfg.head_dim, cfg.num_heads
    norm = {"rmsnorm": d, "layernorm": 2 * d, "nonparam_ln": 0}[cfg.norm]
    head = 0 if tied_head(cfg) else d * cfg.vocab_size
    embed = cfg.vocab_size * d if cfg.frontend == "token" else 0
    base = embed + norm + head
    gqa = d * dh * (h * 2 + cfg.num_kv_heads * 2) + (2 * dh if cfg.qk_norm
                                                      else 0)
    plan = stack_plan(cfg)
    if plan == "xlstm":
        di, nh, _ = mlstm_dims(cfg)
        k = cfg.xlstm.conv_kernel
        mlstm = 3 * d * di + (k + 3) * di + 3 * di * di + 2 * nh * (di + 1)
        slstm = ((k + 6) * d + 4 * d * d + 4 * d * d // nh
                 + 3 * d * slstm_ff(cfg))
        return base + cfg.num_layers // 2 * (2 * norm + mlstm + slstm)
    if plan in ("mamba", "zamba"):
        d_inner, nheads, conv_ch, d_in_proj = mamba_dims(cfg)
        mamba = (d * d_in_proj + (cfg.ssm.conv_kernel + 1) * conv_ch
                 + 3 * nheads + d_inner + d_inner * d)
        total = base + cfg.num_layers * (norm + mamba)
        if plan == "zamba":
            ff = cfg.hybrid.shared_attn_d_ff
            total += (norm + gqa
                      + (norm + mlp_param_count(cfg, ff) if ff > 0 else 0))
        return total
    if cfg.mla.enabled:
        m = cfg.mla
        qd = m.nope_head_dim + m.rope_head_dim
        attn = (d * m.kv_lora_rank + m.kv_lora_rank + d * m.rope_head_dim
                + m.kv_lora_rank * h * (m.nope_head_dim + m.v_head_dim)
                + h * m.v_head_dim * d)
        attn += (d * m.q_lora_rank + m.q_lora_rank + m.q_lora_rank * h * qd
                 if m.q_lora_rank > 0 else d * h * qd)
    else:
        attn = gqa
    if cfg.moe.enabled:
        mo = cfg.moe
        ffn = (d * mo.num_experts + 3 * mo.num_experts * d * mo.expert_d_ff
               + (mlp_param_count(cfg, mo.shared_d_ff * mo.num_shared_experts)
                  if mo.num_shared_experts > 0 else 0)
               + (mlp_param_count(cfg, cfg.d_ff) if mo.dense_residual
                  else 0))
    else:
        ffn = mlp_param_count(cfg, cfg.d_ff)
    layer = 2 * norm + attn + ffn
    return base + cfg.num_layers * layer


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
    """Token ids (B, S) -> embeddings (B, S, d) in the compute dtype, or,
    on the embedding-stub frontend, the precomputed embeddings (B, S, d)
    cast to it. ``F.embedding``: its backward sums repeated tokens
    deterministically on the card."""
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.frontend != "token":
        return inputs.to(cdt)
    return F.embedding(inputs.long(), params["embed"]).to(cdt)


def lm_head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    """The (d, V) head in the compute dtype: ``embed`` transposed (a
    view) when tied. With tied weights the gradient reaches ``embed``
    through both this and the gather of :func:`embed_tokens`, and
    autograd sums the two into the one leaf, as JAX does. A stub
    frontend always has its own ``lm_head``."""
    if tied_head(cfg):
        return _cast(params["embed"], cfg.compute_dtype).t()
    return _cast(params["lm_head"], cfg.compute_dtype)


def unembed(params, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """hidden (..., d) -> logits (..., V), soft-capped if configured."""
    logits = hidden @ lm_head_matrix(params, cfg)
    if cfg.logit_softcap > 0.0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def apply_uniform_layer(p, x: torch.Tensor, cfg: ModelConfig,
                        positions: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm decoder layer, residual: MLA or GQA attention, then
    the MoE at the training capacity (plus Arctic's dense residual MLP on
    the same input) or the MLP. Returns (x, the layer's MoE aux loss, an
    fp32 scalar: 0 for a dense layer)."""
    h = apply_norm(p["ln1"], x, cfg)
    block = mla_block if cfg.mla.enabled else attention_block
    x = x + block(p["attn"], h, cfg, positions)
    h2 = apply_norm(p["ln2"], x, cfg)
    if "moe" in p:
        m, aux = moe_block(p["moe"], h2, cfg)
        if "dense" in p:
            m = m + mlp_block(p["dense"], h2, cfg)
    else:
        m = mlp_block(p["mlp"], h2, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m, aux


def _remat_call(fn, *args, cfg: ModelConfig):
    """``fn(*args)``, under a non-reentrant checkpoint with ``remat=
    "full"`` when a gradient is wanted."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _uniform_stack(layers, x: torch.Tensor, aux: torch.Tensor,
                   cfg: ModelConfig, positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The uniform layers in order, each under a non-reentrant checkpoint
    with ``remat="full"`` when a gradient is wanted; their aux losses
    added to ``aux`` in layer order (the JAX scan's carry)."""
    for lp in layers:
        x, a = _remat_call(apply_uniform_layer, lp, x, cfg, positions,
                           cfg=cfg)
        aux = aux + a
    return x, aux


def _apply_shared_attn(p, x, cfg, positions):
    h = apply_norm(p["ln1"], x, cfg)
    x = x + attention_block(p["attn"], h, cfg, positions)
    if "mlp" in p:
        x = x + mlp_block(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    return x


def _apply_shared_attn_prefill(p, x, cfg, positions):
    h = apply_norm(p["ln1"], x, cfg)
    a, kv = attention_block(p["attn"], h, cfg, positions, return_kv=True)
    x = x + a
    if "mlp" in p:
        x = x + mlp_block(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    return x, kv


def _apply_shared_attn_decode(p, x, cfg, k_cache, v_cache, pos):
    h = apply_norm(p["ln1"], x, cfg)
    a, (k_cache, v_cache) = attention_decode(p["attn"], h, cfg, k_cache,
                                             v_cache, pos)
    x = x + a
    if "mlp" in p:
        x = x + mlp_block(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    return x, (k_cache, v_cache)


def _mamba_layer(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One pre-norm Mamba2 layer, residual."""
    return x + mamba_block(lp["mamba"], apply_norm(lp["ln"], x, cfg), cfg)


def _zamba_group(layers, shared, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    """A zamba group: its Mamba2 layers in order, then the shared
    attention block (the JAX package's ``group_body``)."""
    for lp in layers:
        x = _mamba_layer(lp, x, cfg)
    return _apply_shared_attn(shared, x, cfg, positions)


def _ssm_stack(params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    """The mamba plan's layers, or the zamba plan's groups of
    ``attn_every`` layers each followed by the shared block (layers past
    the last whole group run alone, as serving runs them), each under
    :func:`_remat_call`."""
    layers = params["layers"]
    if stack_plan(cfg) == "mamba":
        for lp in layers:
            x = _remat_call(_mamba_layer, lp, x, cfg, cfg=cfg)
        return x
    every = cfg.hybrid.attn_every
    whole = len(layers) // every * every
    for g0 in range(0, whole, every):
        x = _remat_call(_zamba_group, layers[g0:g0 + every],
                        params["shared_attn"], x, cfg, positions, cfg=cfg)
    for lp in layers[whole:]:
        x = _remat_call(_mamba_layer, lp, x, cfg, cfg=cfg)
    return x


def _xlstm_pair(mp, sp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """An xlstm pair: the pre-norm mLSTM block, then the pre-norm sLSTM
    block, each residual (the JAX package's ``pair_body``)."""
    x = x + mlstm_block(mp["blk"], apply_norm(mp["ln"], x, cfg), cfg)
    return x + slstm_block(sp["blk"], apply_norm(sp["ln"], x, cfg), cfg)


def hidden_states(params, embeds: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """embeds (B, S, d) -> (final-normed hidden (B, S, d), aux loss: the
    layers' MoE aux losses summed, an fp32 scalar; 0 without MoE).

    The training forward of every plan: the uniform plan (dense, MoE at
    the training capacity, MLA), the mamba, zamba and xlstm plans.
    ``cfg.remat``: "full" runs each uniform or Mamba2 layer, each zamba
    group (its Mamba2 layers and the shared block) and each xlstm pair
    (its mLSTM and sLSTM blocks) under a non-reentrant checkpoint (only
    its input is kept; the backward recomputes it, attention, SSD and
    mLSTM kernels and routing included), "none" keeps every activation;
    "dots" (save matmul outputs only) is not ported yet."""
    plan = stack_plan(cfg)
    check_supported(cfg)
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"remat '{cfg.remat}' is not ported yet "
                         f"(none | full)")
    positions = torch.arange(embeds.shape[1], device=embeds.device)
    aux = torch.zeros((), dtype=torch.float32, device=embeds.device)
    if plan == "xlstm":
        x = embeds
        for mp, sp in zip(params["mlstm_layers"], params["slstm_layers"]):
            x = _remat_call(_xlstm_pair, mp, sp, x, cfg, cfg=cfg)
    elif plan in ("mamba", "zamba"):
        x = _ssm_stack(params, embeds, cfg, positions)
    else:
        x, aux = _uniform_stack(params["layers"], embeds, aux, cfg,
                                positions)
    return apply_norm(params["final_norm"], x, cfg), aux


def pipeline_stage_fns(cfg: ModelConfig, stage_ranges, *,
                       label_smoothing: float = 0.0,
                       ce_impl: str = "kernel") -> Dict[str, Any]:
    """The training objective cut into pipeline segments (the JAX
    package's ``pipeline_stage_fns``; ``core/pipeline.py`` StagePlan).

    ``stage_ranges``: contiguous (start, stop) layer ranges tiling
    ``[0, num_layers)``. Returns

      embed_fn(embed_params, inputs)            -> x0 (stage 0's input)
      stage_fwd[s](layer_slice, x, aux, positions) -> (x', aux')
      head_fn(head_params, x, labels, weights)  -> (ce_sum, w_sum)

    and ``head_keys`` (the top-level keys ``head_fn`` reads) and
    ``stage_ranges``. ``layer_slice`` is stage s's part of the layer
    list; each layer runs as in :func:`hidden_states`, under a
    non-reentrant checkpoint with ``remat="full"``, so the segments
    compose to the monolithic forward op for op. ``aux`` threads
    through the stages as the JAX package threads it: each MoE layer
    adds its aux loss, in layer order (a dense layer adds 0). The caller
    composes ``objective = ce_sum + aux * weight`` with the weight
    ``Model.loss_fn``'s ``aux_weight`` gives."""
    from repro_torch.kernels.cross_entropy import ops as ce_ops

    if stack_plan(cfg) != "uniform":
        raise ValueError(
            f"pipeline stages require the uniform stack plan; "
            f"{cfg.name} uses '{stack_plan(cfg)}'")
    ranges = [(int(a), int(b)) for a, b in stage_ranges]
    covered = 0
    for s, (start, stop) in enumerate(ranges):
        if start != covered or stop <= start:
            raise ValueError(
                f"stage_ranges must tile [0, {cfg.num_layers}) "
                f"contiguously; stage {s} got [{start}, {stop}) after "
                f"{covered} covered layers")
        covered = stop
    if covered != cfg.num_layers:
        raise ValueError(
            f"stage_ranges cover {covered} layers, model has "
            f"{cfg.num_layers}")
    check_supported(cfg)
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"remat '{cfg.remat}' is not ported yet "
                         f"(none | full)")

    def embed_fn(embed_params, inputs):
        return embed_tokens(embed_params, inputs, cfg)

    def stage_fwd(layer_slice, x, aux, positions):
        return _uniform_stack(layer_slice, x, aux, cfg, positions)

    def head_fn(head_params, x, labels, weights):
        hidden = apply_norm(head_params["final_norm"], x, cfg)
        b, s, d = hidden.shape
        return ce_ops.weighted_cross_entropy(
            hidden.reshape(b * s, d), lm_head_matrix(head_params, cfg),
            labels.reshape(-1), weights.reshape(-1).float(),
            label_smoothing=label_smoothing,
            logit_softcap=cfg.logit_softcap, impl=ce_impl)

    return {"embed_fn": embed_fn, "stage_fwd": [stage_fwd] * len(ranges),
            "head_fn": head_fn, "head_keys": head_param_keys(cfg),
            "stage_ranges": ranges}


def _ffn_serving(p, h2: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The layer's feed-forward on the serving path: the MoE block at the
    eval capacity (its aux loss dropped), plus the dense residual MLP on
    the same input where the layer has one (Arctic), or the dense MLP."""
    if "moe" in p:
        m = moe_block(p["moe"], h2, cfg, train=False)[0]
        if "dense" in p:
            m = m + mlp_block(p["dense"], h2, cfg)
        return m
    return mlp_block(p["mlp"], h2, cfg)


def _layer_prefill(p, x, cfg, positions):
    h = apply_norm(p["ln1"], x, cfg)
    block = mla_block if cfg.mla.enabled else attention_block
    a, kv = block(p["attn"], h, cfg, positions, return_kv=True)
    x = x + a
    return x + _ffn_serving(p, apply_norm(p["ln2"], x, cfg), cfg), kv


# The xlstm plan's contiguous cache: one flat name per leaf of the JAX
# package's nested cache, {"mlstm": (conv, (C, n, m)), "slstm": (conv,
# (c, n, m, h))}, each stacked over the num_layers // 2 pairs.
XLSTM_CACHE = {"mlstm": ("mlstm_conv", "mlstm_C", "mlstm_n", "mlstm_m"),
               "slstm": ("slstm_conv", "slstm_c", "slstm_n", "slstm_m",
                         "slstm_h")}


def _xlstm_leaves(kind: str, states) -> Dict[str, torch.Tensor]:
    """Per-pair block states (conv, cell tuple) -> the flat cache leaves
    of one block kind, stacked over pairs."""
    per_pair = [(st[0],) + tuple(st[1]) for st in states]
    return {name: torch.stack([leaves[i] for leaves in per_pair])
            for i, name in enumerate(XLSTM_CACHE[kind])}


def _xlstm_state(cache: Dict[str, torch.Tensor], kind: str, p: int):
    """Pair p's block state (conv, cell tuple) as views of the cache."""
    conv, *cell = (cache[name][p] for name in XLSTM_CACHE[kind])
    return conv, tuple(cell)


def cache_names(cfg: ModelConfig) -> Tuple[str, str]:
    """The two cache tensors of a layer: the MLA latent and RoPE key, or
    GQA's k and v."""
    return ("c_kv", "k_rope") if cfg.mla.enabled else ("k", "v")


def prefill(params, embeds: torch.Tensor, cfg: ModelConfig,
            max_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (hidden (B, S, d), cache). Uniform plan: {"k","v"} (L, B,
    max_len, Hkv, Dh), or for MLA {"c_kv"} (L, B, max_len, r) and
    {"k_rope"} (L, B, max_len, Dr). Mamba plan: {"conv"} (L, B, K-1,
    conv_ch) and {"ssm"} (L, B, H, P, N), both in the compute dtype.
    Zamba plan: those, plus {"attn_k","attn_v"} (G, B, max_len, Hkv,
    Dh), one per application of the shared block. Attention positions
    past S are zeros. Xlstm plan: the leaves of :data:`XLSTM_CACHE`,
    (P, B, ...) over the P = num_layers // 2 pairs: the conv tails (P,
    B, K-1, d_inner) and (P, B, K-1, d) in the compute dtype; mLSTM C
    (P, B, H, dk, dk), n (P, B, H, dk), m (P, B, H) and sLSTM c, n, m, h
    (P, B, d) in fp32; ``max_len`` is not read (the state is O(1))."""
    b, s, _ = embeds.shape
    positions = torch.arange(s, device=embeds.device)
    pad = max_len - s

    def stack(parts, pad_seq=True):
        out = torch.stack(parts)
        if pad and pad_seq:
            out = F.pad(out, (0, 0) * (out.ndim - 3) + (0, pad))
        return out

    plan = stack_plan(cfg)
    x = embeds
    kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    if plan == "uniform":
        for lp in params["layers"]:
            x, kv = _layer_prefill(lp, x, cfg, positions)
            kvs.append(kv)
        cache = {name: stack([kv[i] for kv in kvs])
                 for i, name in enumerate(cache_names(cfg))}
    elif plan in ("mamba", "zamba"):
        every = cfg.hybrid.attn_every if plan == "zamba" else 0
        states = []
        for i, lp in enumerate(params["layers"]):
            y, st = mamba_block(lp["mamba"], apply_norm(lp["ln"], x, cfg),
                                cfg, return_state=True)
            x = x + y
            states.append(st)
            if every and (i + 1) % every == 0:
                x, kv = _apply_shared_attn_prefill(params["shared_attn"], x,
                                                   cfg, positions)
                kvs.append(kv)
        cache = {"conv": stack([st[0] for st in states], pad_seq=False),
                 "ssm": stack([st[1] for st in states], pad_seq=False)}
        if plan == "zamba":
            cache["attn_k"] = stack([kv[0] for kv in kvs])
            cache["attn_v"] = stack([kv[1] for kv in kvs])
    elif plan == "xlstm":
        mst, sst = [], []
        for mp, sp in zip(params["mlstm_layers"], params["slstm_layers"]):
            y, st = mlstm_block(mp["blk"], apply_norm(mp["ln"], x, cfg), cfg,
                                return_state=True)
            x = x + y
            mst.append(st)
            y, st = slstm_block(sp["blk"], apply_norm(sp["ln"], x, cfg), cfg,
                                return_state=True)
            x = x + y
            sst.append(st)
        cache = {**_xlstm_leaves("mlstm", mst), **_xlstm_leaves("slstm", sst)}
    else:
        raise ValueError(f"stack plan {plan!r} is not ported yet")
    return apply_norm(params["final_norm"], x, cfg), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device
               ) -> Dict[str, torch.Tensor]:
    """Zero contiguous cache with :func:`prefill`'s structure (every
    plan; MLA keeps the latent and RoPE key). The xlstm plan's
    stabilizers m start at -1e30, as in the JAX package."""
    plan = stack_plan(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    L = cfg.num_layers
    if plan == "xlstm":
        pairs = L // 2
        return {
            **_xlstm_leaves("mlstm",
                            [init_mlstm_state(cfg, batch, device)] * pairs),
            **_xlstm_leaves("slstm",
                            [init_slstm_state(cfg, batch, device)] * pairs)}
    if plan == "uniform":
        init = init_mla_cache if cfg.mla.enabled else init_gqa_cache
        return init(cfg, L, batch, max_len, device)
    if plan not in ("mamba", "zamba"):
        raise ValueError(f"stack plan {plan!r} is not ported yet")
    _, nheads, conv_ch, _ = mamba_dims(cfg)
    s = cfg.ssm
    cache = {
        "conv": torch.zeros((L, batch, s.conv_kernel - 1, conv_ch),
                            dtype=cdt, device=device),
        "ssm": torch.zeros((L, batch, nheads, s.head_dim, s.state_dim),
                           dtype=cdt, device=device)}
    if plan == "zamba":
        groups = cfg.num_layers // cfg.hybrid.attn_every
        shape = (groups, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        cache["attn_k"] = torch.zeros(shape, dtype=cdt, device=device)
        cache["attn_v"] = torch.zeros(shape, dtype=cdt, device=device)
    return cache


def apply_uniform_layer_decode(p, x, cfg, first, second, pos, kv_len):
    """One layer's decode over its two contiguous cache tensors
    (:func:`cache_names`), attending ``kv_len`` = pos + 1 positions."""
    h = apply_norm(p["ln1"], x, cfg)
    decode = mla_decode if cfg.mla.enabled else attention_decode
    a, kv = decode(p["attn"], h, cfg, first, second, pos, kv_len)
    x = x + a
    return x + _ffn_serving(p, apply_norm(p["ln2"], x, cfg), cfg), kv


def decode_step(params, embeds: torch.Tensor, cfg: ModelConfig,
                cache: Dict[str, torch.Tensor], pos: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """embeds (B, 1, d) of the token at position ``pos`` -> (hidden (B, 1,
    d), cache). The contiguous cache is updated in place (the JAX
    function returns a new one) and returned."""
    plan = stack_plan(cfg)
    x = embeds
    if plan == "uniform":
        first, second = cache_names(cfg)
        kv_len = torch.full((x.shape[0],), int(pos) + 1, dtype=torch.int32,
                            device=x.device)
        for i, lp in enumerate(params["layers"]):
            x, _ = apply_uniform_layer_decode(lp, x, cfg, cache[first][i],
                                              cache[second][i], pos, kv_len)
    elif plan in ("mamba", "zamba"):
        every = cfg.hybrid.attn_every if plan == "zamba" else 0
        for i, lp in enumerate(params["layers"]):
            y, (conv, ssm) = mamba_decode_step(
                lp["mamba"], apply_norm(lp["ln"], x, cfg), cfg,
                (cache["conv"][i], cache["ssm"][i]))
            x = x + y
            cache["conv"][i] = conv
            cache["ssm"][i] = ssm
            if every and (i + 1) % every == 0:
                g = (i + 1) // every - 1
                x, _ = _apply_shared_attn_decode(
                    params["shared_attn"], x, cfg, cache["attn_k"][g],
                    cache["attn_v"][g], pos)
    elif plan == "xlstm":
        for p, (mp, sp) in enumerate(zip(params["mlstm_layers"],
                                         params["slstm_layers"])):
            for kind, lp, step in (("mlstm", mp, mlstm_block_decode),
                                   ("slstm", sp, slstm_block_decode)):
                y, (conv, cell) = step(lp["blk"], apply_norm(lp["ln"], x, cfg),
                                       cfg, _xlstm_state(cache, kind, p))
                x = x + y
                for name, t in zip(XLSTM_CACHE[kind], (conv,) + tuple(cell)):
                    cache[name][p] = t
    else:
        raise ValueError(f"stack plan {plan!r} is not ported yet")
    return apply_norm(params["final_norm"], x, cfg), cache


def init_paged_cache(cfg: ModelConfig, layout: PagedLayout, device
                     ) -> Dict[str, torch.Tensor]:
    """Zero paged block pool for the uniform attention stack."""
    check_paged(cfg)
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
