"""Absorbed-MLA decode ops with implementation dispatch
(port of ``repro/kernels/mla_decode/ops.py``; see ``ref.py`` for the
layouts).

``impl``:
  * "reference" / "dense" — the fp32 dense oracle (the paged op gathers
    the window first, NULL blocks as zeros);
  * "kernel" — the hand-written CUDA kernel (``mla_decode.py``) for CUDA
    tensors, its plain version for CPU tensors. The JAX package's
    "pallas" maps to "kernel", as for the other attention ops.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mla_decode import ref
from repro_torch.kernels.mla_decode.mla_decode import (mla_decode_cuda,
                                                       mla_decode_paged_cuda)


def mla_decode_attention(q_abs, q_r, ckv, kr, kv_len, scale: float, *,
                         impl: str = "dense") -> torch.Tensor:
    if impl in ("reference", "dense"):
        return ref.mla_decode_dense(q_abs, q_r, ckv, kr, kv_len, scale)
    if impl == "kernel":
        return mla_decode_cuda(q_abs, q_r, ckv, kr, kv_len, scale)
    raise ValueError(f"unknown mla decode impl '{impl}'")


def mla_decode_paged_attention(q_abs, q_r, ckv_pool, kr_pool, block_tables,
                               kv_lens, scale: float, *,
                               impl: str = "reference") -> torch.Tensor:
    """Decode over a paged latent pool; ``kv_lens`` are effective lengths
    (callers attending to a just-written token pass ``cached + 1``)."""
    if impl in ("reference", "dense"):
        return ref.mla_decode_paged_ref(q_abs, q_r, ckv_pool, kr_pool,
                                        block_tables, kv_lens, scale)
    if impl == "kernel":
        return mla_decode_paged_cuda(q_abs, q_r, ckv_pool, kr_pool,
                                     block_tables, kv_lens, scale)
    raise ValueError(f"unknown mla decode impl '{impl}'")
