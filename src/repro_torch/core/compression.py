"""Int8 gradient compression with error feedback
(port of ``repro/core/compression.py``).

Applied only to the cross-pod leg of the hierarchical reduction (and
nowhere else). Per leaf or per bucket, per step:
  1. corrected = grad + error_state           (error feedback)
  2. q, scales = blockwise int8 quantize (``kernels/quantize``)
  3. exchange q + scales (fused into one int8 wire payload,
     :func:`fuse_payload`: one collective a leg)
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


# the wire format of the bucketed exchange (kernels/quantize/ref.py, where
# the exchange's legs and their kernels read and write it)
fuse_payload = q_ref.fuse_payload
split_payload = q_ref.split_payload


def compression_ratio(leaves: Sequence[torch.Tensor],
                      block_size: int = 256) -> float:
    """Bytes(int8 + scales) / bytes(fp32) for a list of gradient leaves."""
    fp = sum(g.numel() * 4 for g in leaves)
    comp = sum(g.numel() + -(-g.numel() // block_size) * 4 for g in leaves)
    return comp / fp
