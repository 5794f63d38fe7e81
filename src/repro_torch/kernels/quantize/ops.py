"""Int8 quantize / dequant-accumulate and the bucketed exchange's legs
with implementation dispatch (port of ``repro/kernels/quantize/ops.py``,
plus the legs).

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

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.quantize import ref
from repro_torch.kernels.quantize.quantize import (
    BLOCK, dequant_accum_cuda, exchange_decode_cuda, exchange_receive_cuda,
    exchange_send_cuda, quantize_int8_cuda)

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


def exchange_send(x: torch.Tensor, e: Optional[torch.Tensor], d_rows: int,
                  *, noise: Optional[torch.Tensor] = None,
                  block_size: int = 256, impl: str = "reference"
                  ) -> Tuple[torch.Tensor, List[int]]:
    """The send leg of an exchange chunk (nbc, p, shard) -> (wire, rows
    of each message); ``ref.exchange_send``."""
    if _on_card(x, impl, block_size):
        return exchange_send_cuda(x, e, d_rows, noise)
    return ref.exchange_send(x, e, d_rows, noise, block_size)


def exchange_receive(rx: torch.Tensor, e: Optional[torch.Tensor], me: int,
                     *, block_size: int = 256, impl: str = "reference"
                     ) -> torch.Tensor:
    """The receive leg: (p, L, B + 4) messages -> the gather leg's (p L,
    B + 4) messages; ``ref.exchange_receive``."""
    if _on_card(rx, impl, block_size):
        return exchange_receive_cuda(rx, e, me)
    return ref.exchange_receive(rx, e, me, block_size)


def exchange_decode(g: torch.Tensor, lens: Sequence[int], x: torch.Tensor,
                    *, block_size: int = 256, impl: str = "reference"
                    ) -> torch.Tensor:
    """The decode of the gathered wire into every slot of ``x``;
    ``ref.exchange_decode``."""
    if _on_card(x, impl, block_size):
        return exchange_decode_cuda(g, lens, x)
    return ref.exchange_decode(g, lens, x, block_size)
