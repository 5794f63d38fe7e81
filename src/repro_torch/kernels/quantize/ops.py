"""Int8 quantize / dequant-accumulate with implementation dispatch
(port of ``repro/kernels/quantize/ops.py``).

``impl``:
  * "reference" — the plain versions (``ref.py``);
  * "kernel"    — the CUDA kernels (``quantize.py``) for CUDA tensors,
                  the plain versions for CPU tensors. The JAX package's
                  "pallas" (``HetConfig.quantize_impl``) maps to
                  "kernel", as for attention and cross entropy.

Stochastic rounding takes its uniform noise from the caller
(``noise``, shaped like the padded blocks) instead of a key.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.quantize import ref
from repro_torch.kernels.quantize.quantize import (BLOCK, dequant_accum_cuda,
                                                   quantize_int8_cuda)

IMPLS = ("reference", "kernel")


def impl_of(quantize_impl: str) -> str:
    """``HetConfig.quantize_impl`` (the JAX package's values) -> this
    module's ``impl``."""
    if quantize_impl == "pallas":
        return "kernel"
    if quantize_impl in IMPLS:
        return quantize_impl
    raise ValueError(f"unknown quantize impl '{quantize_impl}'")


def _on_card(t: torch.Tensor, impl: str, block_size: int) -> bool:
    if impl == "reference":
        return False
    if impl != "kernel":
        raise ValueError(f"unknown quantize impl '{impl}'")
    if t.device.type == "cpu":
        return False
    if block_size != BLOCK:
        raise ValueError(f"impl='kernel' on {t.device}: the CUDA kernels "
                         f"take block_size {BLOCK}, got {block_size}")
    return True


def quantize_int8(x: torch.Tensor, *, block_size: int = 256,
                  noise: Optional[torch.Tensor] = None,
                  impl: str = "reference"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any shape -> (q (nb, block_size) int8, s (nb,) fp32)."""
    blocks = ref.to_blocks(x, block_size)
    if _on_card(blocks, impl, block_size):
        return quantize_int8_cuda(
            blocks.contiguous(),
            noise.contiguous() if noise is not None else None)
    return ref.quantize_blocks(blocks, noise)


def dequant_accum(q: torch.Tensor, scale: torch.Tensor, *,
                  impl: str = "reference") -> torch.Tensor:
    """(R, nb, B) int8, (R, nb) fp32 -> (nb, B) fp32 shard sum."""
    if _on_card(q, impl, q.shape[-1]):
        return dequant_accum_cuda(q.contiguous(), scale.contiguous())
    return ref.dequant_accum(q, scale)
