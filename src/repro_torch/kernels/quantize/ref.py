"""Plain PyTorch per-block int8 quantization (gradient compression)
(port of ``repro/kernels/quantize/ref.py``).

The plain versions of the two CUDA kernels in ``csrc/quantize.cu``, and
the CPU path of ``ops.py``. They keep the JAX oracle's order of
operations so that the codes and scales are bitwise those of JAX and of
the kernels: ``scale = max(absmax / 127, 1e-12)`` with a true division
by a tensor (PyTorch's CUDA division by a Python scalar multiplies by
the reciprocal), ``x / scale`` (a division), round half to even, clip.
Stochastic rounding takes the uniform noise as an argument instead of a
key: ``jax.random`` and ``torch.Generator`` give different numbers, so
the caller draws it (the JAX package draws it inside the op).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def to_blocks(x: torch.Tensor, block_size: int = 256) -> torch.Tensor:
    """Flatten to fp32 and zero-pad to whole blocks: (nb, block_size)."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block_size)


def quantize_blocks(blocks: torch.Tensor,
                    noise: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nb, B) fp32 -> (int8 codes (nb, B), fp32 scales (nb,)); the plain
    version of ``quantize_int8_cuda``. ``noise``: (nb, B) fp32 in [0, 1)
    for stochastic rounding."""
    amax = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    scaled = blocks / scale
    if noise is not None:
        scaled = scaled + (noise - 0.5)
    q = torch.clamp(torch.round(scaled), -127, 127)
    return q.to(torch.int8), scale[:, 0]


def quantize_int8(x: torch.Tensor, *, block_size: int = 256,
                  noise: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any shape, flattened -> (int8 values (nb, B), fp32 per-block
    scales (nb,)); the tail of the last block is zero padding."""
    return quantize_blocks(to_blocks(x, block_size), noise)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int], block_size: int = 256
                    ) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= int(d)
    return flat[:n].reshape(tuple(shape))


def dequant_accum(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``sum_r q[r] * scale[r]`` for q (R, nb, B) int8 and scale (R, nb)
    fp32 -> (nb, B) fp32; the plain version of ``dequant_accum_cuda``.
    A loop over ranks in order from a zero accumulator, one rounded
    product and one rounded sum per rank, as the kernel does (the JAX
    oracle is an einsum: equal to rounding)."""
    acc = torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
    for r in range(q.shape[0]):
        acc = acc + q[r].to(torch.float32) * scale[r].to(torch.float32)[:,
                                                                        None]
    return acc
