"""Public attention ops with implementation dispatch
(port of ``repro/kernels/flash_attention/ops.py``).

``impl``:
  * "reference" — chunked online-softmax torch (``ref.mha_chunked``)
  * "dense"     — full score matrix (``ref.mha_dense``)
  * "kernel"    — the hand-written CUDA kernel (``flash_attention.py``)
                  for CUDA tensors, its plain version for CPU tensors.
                  Where a gradient is wanted it goes through
                  ``FlashAttentionFn``: the forward kernel with its lse,
                  then the backward kernel (``flash_bwd_ref`` on CPU).

"reference" and "dense" are differentiable by autograd through their
plain PyTorch operations.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    FlashAttentionFn, flash_attention_cuda, flash_decode_paged_cuda)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
    impl: str = "reference",
    chunk_size: int = 512,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if impl == "dense":
        return ref.mha_dense(q, k, v, causal=causal, q_offset=q_offset,
                             softmax_scale=softmax_scale, kv_len=kv_len)
    if impl == "reference":
        return ref.mha_chunked(q, k, v, causal=causal, q_offset=q_offset,
                               softmax_scale=softmax_scale,
                               chunk_size=chunk_size, kv_len=kv_len)
    if impl == "kernel":
        if kv_len is not None:
            raise ValueError("impl='kernel' takes no kv_len: the prefill "
                             "kernel masks only positions >= Skv")
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, causal, q_offset,
                                          softmax_scale)
        return flash_attention_cuda(q, k, v, causal=causal,
                                    q_offset=q_offset,
                                    softmax_scale=softmax_scale)
    raise ValueError(f"unknown attention impl '{impl}'")


def flash_decode_paged(
    q: torch.Tensor,                     # (B, 1, H, D)
    k_pool: torch.Tensor,                # (N, bs, Hkv, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,          # (B, MB) int32, NULL == N
    kv_lens: torch.Tensor,               # (B,) int32 effective lengths
    *,
    softmax_scale: Optional[float] = None,
    impl: str = "reference",
) -> torch.Tensor:
    """Single-query GQA decode over a paged pool (serving hot path).

    "reference"/"dense" materialize each sequence's window (NULL blocks
    as zeros) and run ``ref.mha_dense``; "kernel" gathers the blocks
    through the block table inside the CUDA kernel. ``kv_lens`` are
    effective lengths: callers attending to a just-written token pass
    ``cached + 1``.
    """
    if impl in ("reference", "dense"):
        return ref.paged_decode_ref(q, k_pool, v_pool, block_tables,
                                    kv_lens, softmax_scale=softmax_scale)
    if impl == "kernel":
        return flash_decode_paged_cuda(q, k_pool, v_pool, block_tables,
                                       kv_lens, softmax_scale=softmax_scale)
    raise ValueError(f"unknown attention impl '{impl}'")
