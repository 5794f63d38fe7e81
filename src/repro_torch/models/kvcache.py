"""KV caches and single-token decode attention (port of
``repro/models/kvcache.py``): the contiguous GQA cache of static-batch
serving, and the paged family, GQA and absorbed MLA.

**Contiguous** (static-batch serving): one slab per sequence slot in
the compute dtype, GQA k/v (L, B, S_max, Hkv, Dh) (``init_gqa_cache``,
``attention_decode``) or the MLA latent ``c_kv`` (L, B, S_max, r) and
RoPE key ``k_rope`` (L, B, S_max, Dr) (``init_mla_cache``,
``mla_decode``). Decode writes position ``pos`` and attends ``pos + 1``
positions: GQA with the dense oracle, as the JAX package does (no
kernel on this path there either); MLA with the dense path JAX writes,
or under ``attention_impl="kernel"`` the contiguous MLA decode kernel
(the JAX package keeps its dense path here: ``mla_decode_pallas`` is on
none of its paths).

**Paged**: the cache is a pool of fixed-size blocks in the compute
dtype, and each sequence owns a block table mapping its logical block j
to a physical pool block:
  GQA : ``k``/``v`` (L, N, bs, Hkv, Dh)
  MLA : ``c_kv`` (L, N, bs, r) latent + ``k_rope`` (L, N, bs, Dr)
Unmapped entries hold the NULL sentinel ``N`` (one past the pool). The JAX package relies on
``mode="drop"`` scatters and ``mode="fill"`` gathers to make NULL
entries inert; PyTorch raises on (or, on the card, faults at) an
out-of-range index, so the port masks them: a write at a NULL entry is
dropped before it is issued and a NULL block is read as zeros without
being read at all. The pool is not padded with a spare block.

Unlike the JAX functions, which return new arrays, these update the
cache or pool in place (it is the largest tensor of the serving state)
and return it for symmetry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.kernels.mla_decode.ref import NEG_INF, gather_blocks
from repro_torch.models.blocks import (_cast, attention_qkv, dtype_of,
                                       mla_latent, mla_queries)


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Geometry of a paged KV pool: ``num_blocks`` blocks of
    ``block_size`` tokens; a sequence maps at most
    ``max_blocks_per_seq`` blocks; NULL == ``num_blocks``."""
    block_size: int
    num_blocks: int
    max_blocks_per_seq: int

    def __post_init__(self):
        if self.block_size <= 0 or self.num_blocks <= 0:
            raise ValueError(
                f"PagedLayout needs positive block_size/num_blocks, got "
                f"{self.block_size}/{self.num_blocks}")
        if self.max_blocks_per_seq <= 0:
            raise ValueError("PagedLayout.max_blocks_per_seq must be "
                             f"positive, got {self.max_blocks_per_seq}")

    @property
    def null_block(self) -> int:
        return self.num_blocks

    @property
    def max_seq_len(self) -> int:
        return self.block_size * self.max_blocks_per_seq

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold n_tokens (ceil-div; 0 tokens -> 0)."""
        return -(-n_tokens // self.block_size)


def init_gqa_cache(cfg: ModelConfig, num_layers: int, batch: int,
                   max_len: int, device) -> Dict[str, torch.Tensor]:
    cdt = dtype_of(cfg.compute_dtype)
    shape = (num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def attention_decode(params, x: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: int, kv_len: Optional[torch.Tensor] = None):
    """One-token attention over a contiguous cache. x (B, 1, d); caches
    (B, S_max, Hkv, Dh), updated in place. ``pos`` is the index of the
    new token: it is written there and ``pos + 1`` positions are
    attended with the dense oracle (``mha_dense``); ``kv_len`` is that
    length as an int32 (B,) tensor, if the caller has it. Returns (y (B,
    1, d), (k_cache, v_cache))."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.tensor([pos], device=x.device)
    q, k, v = attention_qkv(params, x, cfg, positions)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    if kv_len is None:
        kv_len = torch.full((b,), pos + 1, dtype=torch.int32,
                            device=x.device)
    out = attn_ref.mha_dense(q, k_cache, v_cache, causal=False,
                             kv_len=kv_len)
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim)
    y = out @ _cast(params["wo"], cfg.compute_dtype)
    return y, (k_cache, v_cache)


def init_mla_cache(cfg: ModelConfig, num_layers: int, batch: int,
                   max_len: int, device) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    cdt = dtype_of(cfg.compute_dtype)
    base = (num_layers, batch, max_len)
    return {"c_kv": torch.zeros(base + (m.kv_lora_rank,), dtype=cdt,
                                device=device),
            "k_rope": torch.zeros(base + (m.rope_head_dim,), dtype=cdt,
                                  device=device)}


def _mla_query_latent(params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor):
    """The new token's absorbed queries and latent: q_abs (B, H, r),
    W_uk folded into q_nope (fp32 sums cast to the compute dtype), q_r (B,
    H, Dr), both contiguous; c_kv (B, 1, r) and k_r (B, 1, Dr)."""
    m, h = cfg.mla, cfg.num_heads
    cdt = dtype_of(cfg.compute_dtype)
    q_nope, q_rope = mla_queries(params, x, cfg, positions)
    c_kv, k_r = mla_latent(params, x, cfg, positions)
    w_uk = _cast(params["w_uk"], cfg.compute_dtype).reshape(
        m.kv_lora_rank, h, m.nope_head_dim)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                         w_uk.float()).to(cdt).contiguous()
    return q_abs, q_rope[:, 0].to(cdt).contiguous(), c_kv, k_r


def _mla_dense(q_abs, q_r, ckv, kr, kv_len, scale: float, cdt
               ) -> torch.Tensor:
    """The JAX reference path's latent attention over a dense window
    (B, S, .): fp32 scores, positions >= kv_len filled with -1e30,
    softmax, the probabilities cast to the compute dtype, an fp32 value
    product. Returns (B, H, r) fp32."""
    scores = (torch.einsum("bhr,bsr->bhs", q_abs.float(), ckv.float())
              + torch.einsum("bhd,bsd->bhs", q_r.float(),
                             kr.float())) * scale
    mask = (torch.arange(ckv.shape[1], device=ckv.device)[None, None, :]
            < kv_len[:, None, None])
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cdt)
    return torch.einsum("bhs,bsr->bhr", probs.float(), ckv.float())


def _mla_out(params, out_lat: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    """The latent output (B, H, r) back through W_uv, then wo: (B, 1,
    d)."""
    m, h = cfg.mla, cfg.num_heads
    cdt = dtype_of(cfg.compute_dtype)
    w_uv = _cast(params["w_uv"], cfg.compute_dtype).reshape(
        m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", out_lat.to(cdt).float(), w_uv.float())
    out = out.reshape(out_lat.shape[0], 1, h * m.v_head_dim).to(cdt)
    return out @ _cast(params["wo"], cfg.compute_dtype)


def _mla_scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return (m.nope_head_dim + m.rope_head_dim) ** -0.5


def mla_decode(params, x: torch.Tensor, cfg: ModelConfig,
               ckv_cache: torch.Tensor, kr_cache: torch.Tensor, pos: int,
               kv_len: torch.Tensor):
    """One-token absorbed-MLA attention over the contiguous latent
    cache. x (B, 1, d); ckv_cache (B, S_max, r), kr_cache (B, S_max, Dr),
    updated in place. ``pos`` is the index of the new token: it is
    written there and ``pos + 1`` positions are attended. ``kv_len`` is
    that length as an int32 (B,) tensor on the device, ``pos + 1`` on
    every row (a decode step makes it once for all layers); the RoPE
    position is read from it on the device. W_uk is folded into the query,
    the scores are taken against the shared latent with scale (nope +
    rope)^-0.5, and W_uv then wo map the latent output back. With
    ``attention_impl="kernel"`` the attention is the contiguous MLA
    decode kernel; otherwise the dense path as the JAX package writes it.
    Returns (y (B, 1, d), (ckv_cache, kr_cache))."""
    pos = int(pos)
    if kv_len.shape != (x.shape[0],):
        raise ValueError(f"kv_len of shape {tuple(kv_len.shape)}, want "
                         f"({x.shape[0]},)")
    # the position (1,) made on the device from the length: a copy from
    # the host would wait for the device in every layer
    q_abs, q_r, c_kv, k_r = _mla_query_latent(params, x, cfg,
                                              kv_len[:1] - 1)
    ckv_cache[:, pos] = c_kv[:, 0].to(ckv_cache.dtype)
    kr_cache[:, pos] = k_r[:, 0].to(kr_cache.dtype)
    if cfg.attention_impl == "kernel":
        out_lat = mla_ops.mla_decode_attention(
            q_abs, q_r, ckv_cache, kr_cache, kv_len, _mla_scale(cfg),
            impl="kernel")
    else:
        out_lat = _mla_dense(q_abs, q_r, ckv_cache, kr_cache, kv_len,
                             _mla_scale(cfg), dtype_of(cfg.compute_dtype))
    return _mla_out(params, out_lat, cfg), (ckv_cache, kr_cache)


def init_gqa_paged_cache(cfg: ModelConfig, num_layers: int,
                         layout: PagedLayout, device
                         ) -> Dict[str, torch.Tensor]:
    shape = (num_layers, layout.num_blocks, layout.block_size,
             cfg.num_kv_heads, cfg.head_dim)
    cdt = dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def init_mla_paged_cache(cfg: ModelConfig, num_layers: int,
                         layout: PagedLayout, device
                         ) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    base = (num_layers, layout.num_blocks, layout.block_size)
    cdt = dtype_of(cfg.compute_dtype)
    return {"c_kv": torch.zeros(base + (m.kv_lora_rank,), dtype=cdt,
                                device=device),
            "k_rope": torch.zeros(base + (m.rope_head_dim,), dtype=cdt,
                                  device=device)}


def write_prefill_blocks(paged: Dict[str, torch.Tensor],
                         contiguous: Dict[str, torch.Tensor],
                         block_tables: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
    """Scatter a contiguous prefill cache (L, B, S_pad, ...) into the
    pool: chunk j of sequence i lands in block ``block_tables[i, j]``;
    NULL (out-of-pool) entries drop the chunk. Tokens past a sequence's
    real length carry padding K/V; ``kv_lens`` masks them at decode and
    decode overwrites them in place."""
    for name, dst in paged.items():
        src = contiguous[name]
        l, b, s_pad = src.shape[:3]
        bs, n = dst.shape[2], dst.shape[1]
        if s_pad % bs:
            raise ValueError(f"prefill length {s_pad} not a multiple of "
                             f"block size {bs}")
        nc = s_pad // bs
        chunks = src.reshape((l, b, nc, bs) + tuple(src.shape[3:]))
        tables = block_tables[:, :nc].long()
        keep = (tables >= 0) & (tables < n)
        dst[:, tables[keep]] = chunks[:, keep].to(dst.dtype)
    return paged


def decode_write_index(block_tables: torch.Tensor, kv_lens: torch.Tensor,
                       block_size: int, num_blocks: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each sequence's new token goes: (rows, blocks, offsets) of
    the sequences whose current block is a real pool block. Rows whose
    block is NULL (inactive slots) are left out, which is the JAX
    ``mode="drop"`` write. The same for every layer of a step, so a
    step computes it once."""
    bs = block_size
    mb = block_tables.shape[1]
    j = (kv_lens // bs).long()
    in_table = j < mb
    blk = torch.gather(block_tables.long(), 1,
                       torch.clamp(j, max=mb - 1)[:, None])[:, 0]
    keep = in_table & (blk >= 0) & (blk < num_blocks)
    rows = torch.nonzero(keep, as_tuple=True)[0]
    return rows, blk[rows], (kv_lens % bs).long()[rows]


def attention_decode_paged(params, x: torch.Tensor, cfg: ModelConfig,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           block_tables: torch.Tensor,
                           kv_lens: torch.Tensor,
                           write_index: Optional[Tuple] = None):
    """One-token attention over a paged pool, one depth per sequence.

    x (B, 1, d); caches (N, bs, Hkv, Dh), updated in place;
    block_tables (B, MB) int32; kv_lens (B,) int32 tokens already
    cached (the new token is written at position kv_lens[i] and attended
    to, so the effective length is kv_lens + 1). ``write_index`` is
    :func:`decode_write_index` of these tables, if the caller has it.
    Returns (y (B, 1, d), (k_cache, v_cache)).
    """
    b = x.shape[0]
    n, bs = k_cache.shape[:2]
    q, k, v = attention_qkv(params, x, cfg, kv_lens[:, None])
    if write_index is None:
        write_index = decode_write_index(block_tables, kv_lens, bs, n)
    rows, blk, off = write_index
    k_cache[blk, off] = k[rows, 0].to(k_cache.dtype)
    v_cache[blk, off] = v[rows, 0].to(v_cache.dtype)
    out = attn_ops.flash_decode_paged(
        q, k_cache, v_cache, block_tables, kv_lens + 1,
        impl=cfg.attention_impl)
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim)
    y = out @ _cast(params["wo"], cfg.compute_dtype)
    return y, (k_cache, v_cache)


def mla_decode_paged(params, x: torch.Tensor, cfg: ModelConfig,
                     ckv_cache: torch.Tensor, kr_cache: torch.Tensor,
                     block_tables: torch.Tensor, kv_lens: torch.Tensor,
                     write_index: Optional[Tuple] = None):
    """One-token absorbed-MLA attention over a paged latent pool.

    x (B, 1, d); ckv_cache (N, bs, r), kr_cache (N, bs, Dr), updated in
    place; block_tables (B, MB); kv_lens (B,) tokens already cached (the
    effective length is kv_lens + 1). W_uk is folded into the query
    (``q_abs``, fp32 sums cast to the compute dtype), the scores are
    taken against the shared latent, MQA-style, with scale (nope +
    rope)^-0.5, and W_uv then wo map the latent output back. With
    ``attention_impl="kernel"`` the attention is the paged kernel (the
    block-table gather inside it); otherwise the window is gathered and
    the probabilities are cast to the compute dtype before the value
    product, as the JAX reference path does.
    Returns (y (B, 1, d), (ckv_cache, kr_cache)).
    """
    n, bs = ckv_cache.shape[:2]
    q_abs, q_r, c_kv, k_r = _mla_query_latent(params, x, cfg,
                                              kv_lens[:, None])
    if write_index is None:
        write_index = decode_write_index(block_tables, kv_lens, bs, n)
    rows, blk, off = write_index
    ckv_cache[blk, off] = c_kv[rows, 0].to(ckv_cache.dtype)
    kr_cache[blk, off] = k_r[rows, 0].to(kr_cache.dtype)
    if cfg.attention_impl == "kernel":
        out_lat = mla_ops.mla_decode_paged_attention(
            q_abs, q_r, ckv_cache, kr_cache, block_tables, kv_lens + 1,
            _mla_scale(cfg), impl="kernel")
    else:
        out_lat = _mla_dense(
            q_abs, q_r, gather_blocks(ckv_cache, block_tables),
            gather_blocks(kr_cache, block_tables), kv_lens + 1,
            _mla_scale(cfg), dtype_of(cfg.compute_dtype))
    return _mla_out(params, out_lat, cfg), (ckv_cache, kr_cache)
