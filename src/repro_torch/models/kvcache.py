"""Paged KV cache and single-token paged decode attention
(port of the paged GQA family of ``repro/models/kvcache.py``).

The cache is a pool of fixed-size blocks, ``k``/``v`` (L, N, bs, Hkv,
Dh) in the compute dtype, and each sequence owns a block table mapping
its logical block j to a physical pool block. Unmapped entries hold the
NULL sentinel ``N`` (one past the pool). The JAX package relies on
``mode="drop"`` scatters and ``mode="fill"`` gathers to make NULL
entries inert; PyTorch raises on (or, on the card, faults at) an
out-of-range index, so the port masks them: a write at a NULL entry is
dropped before it is issued and a NULL block is read as zeros without
being read at all. The pool is not padded with a spare block.

Unlike the JAX functions, which return new arrays, these update the
pool in place (it is the largest tensor of the serving state) and
return it for symmetry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.blocks import _cast, attention_qkv, dtype_of


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


def init_gqa_paged_cache(cfg: ModelConfig, num_layers: int,
                         layout: PagedLayout, device
                         ) -> Dict[str, torch.Tensor]:
    shape = (num_layers, layout.num_blocks, layout.block_size,
             cfg.num_kv_heads, cfg.head_dim)
    cdt = dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


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
