"""Weighted cross-entropy op with implementation dispatch
(port of ``repro/kernels/cross_entropy/ops.py``).

``impl``:
  * "dense"     — full fp32 logits (``ref.ce_dense``)
  * "reference" — token chunks (``ref.ce_chunked``), autograd through it
  * "kernel"    — the CUDA kernels (``cross_entropy.CrossEntropyFn``) for
                  CUDA tensors, their plain versions for CPU tensors. The
                  JAX package's "pallas" maps to "kernel".
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.cross_entropy import ref
from repro_torch.kernels.cross_entropy.cross_entropy import (
    BWD_CHUNK, CrossEntropyFn, cross_entropy_cuda)

CE_IMPLS = ("dense", "reference", "kernel")


def weighted_cross_entropy(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    *,
    label_smoothing: float = 0.0,
    logit_softcap: float = 0.0,
    impl: str = "kernel",
    chunk_size: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weighted_loss_sum, weight_sum) — HetSeq aggregation contract."""
    if impl == "dense":
        return ref.ce_dense(hidden, lm_head, labels, weights,
                            label_smoothing=label_smoothing,
                            logit_softcap=logit_softcap)
    if impl == "reference":
        return ref.ce_chunked(hidden, lm_head, labels, weights,
                              label_smoothing=label_smoothing,
                              logit_softcap=logit_softcap,
                              chunk_size=chunk_size)
    if impl == "kernel":
        if torch.is_grad_enabled() and (hidden.requires_grad
                                        or lm_head.requires_grad):
            return CrossEntropyFn.apply(hidden, lm_head, labels, weights,
                                        float(label_smoothing),
                                        float(logit_softcap),
                                        min(chunk_size, BWD_CHUNK))
        return cross_entropy_cuda(hidden, lm_head, labels, weights,
                                  label_smoothing=label_smoothing,
                                  logit_softcap=logit_softcap)
    raise ValueError(f"unknown cross-entropy impl '{impl}'")
