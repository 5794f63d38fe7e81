"""Int8 gradient compression with error feedback
(port of ``repro/core/compression.py``).

Applied only to the cross-pod leg of the hierarchical reduction (and
nowhere else). Per leaf or per bucket, per step:
  1. corrected = grad + error_state           (error feedback)
  2. q, scales = blockwise int8 quantize (``kernels/quantize``)
  3. exchange q + scales (``core/buckets.py`` fuses the scales into the
     int8 wire payload with :func:`fuse_payload`, one collective)
  4. error_state' = corrected - dequant(q)

Leaves are listed in the JAX package's pytree flatten order
(``core/buckets.py::stream_leaves``): sorted dict keys, each stacked
layer leaf as one (L, ...) leaf.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.kernels.quantize import ref as q_ref


def compress_leaf(g: torch.Tensor, err: torch.Tensor,
                  noise: Optional[torch.Tensor] = None,
                  block_size: int = 256, impl: str = "reference"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8 blocks, scales, new_error)."""
    corrected = g.to(torch.float32) + err
    q, s = q_ops.quantize_int8(corrected, block_size=block_size,
                               noise=noise, impl=impl)
    deq = q_ref.dequantize_int8(q, s, corrected.shape, block_size)
    return q, s, corrected - deq


def compress_tree(leaves: Sequence[torch.Tensor],
                  errs: Sequence[torch.Tensor],
                  noises: Optional[Sequence[torch.Tensor]] = None,
                  block_size: int = 256, impl: str = "reference"
                  ) -> Tuple[Tuple[List, List], List]:
    """Quantize every leaf (a list in flatten order). Returns
    ((q list, s list), new error list). ``noises``: one (nb, B) uniform
    tensor per leaf, or None for round to nearest."""
    noises = noises if noises is not None else [None] * len(leaves)
    qs, ss, nes = [], [], []
    for g, e, n in zip(leaves, errs, noises):
        q, s, ne = compress_leaf(g, e, n, block_size, impl)
        qs.append(q)
        ss.append(s)
        nes.append(ne)
    return (qs, ss), nes


def decompress_tree(qs: Sequence[torch.Tensor], ss: Sequence[torch.Tensor],
                    shapes: Sequence[Sequence[int]],
                    block_size: int = 256) -> List[torch.Tensor]:
    """Dequantize every leaf back to its shape."""
    return [q_ref.dequantize_int8(q, s, shape, block_size)
            for q, s, shape in zip(qs, ss, shapes)]


def fuse_payload(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Int8 values + fp32 scales as ONE int8 wire buffer: each block's
    ``block_size`` codes followed by its scale's 4 bytes (bit-cast,
    native byte order), (..., blocks, block_size + 4). Byte-equal to the
    JAX package's payload on current jax (``NATIVE_MANUAL_COLLECTIVES``)."""
    s_bytes = s.to(torch.float32).contiguous().view(torch.int8).reshape(
        *s.shape, 4)
    return torch.cat([q, s_bytes], dim=-1)


def split_payload(payload: torch.Tensor, block_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`fuse_payload`: -> (q int8, s fp32)."""
    if payload.dtype != torch.int8:
        raise TypeError(f"split_payload: int8 payload expected, got "
                        f"{payload.dtype}")
    q = payload[..., :block_size]
    s = payload[..., block_size:].contiguous().view(torch.float32)
    return q, s[..., 0]


def compression_ratio(leaves: Sequence[torch.Tensor],
                      block_size: int = 256) -> float:
    """Bytes(int8 + scales) / bytes(fp32) for a list of gradient leaves."""
    fp = sum(g.numel() * 4 for g in leaves)
    comp = sum(g.numel() + -(-g.numel() // block_size) * 4 for g in leaves)
    return comp / fp
